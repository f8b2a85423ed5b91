#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build of every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
     source, in parallel, timed);
  3. each of the six kernels, and the int8 variants of four of them
     (fused_smw[int8], fused_block_smw[int8], fused_precond[int8] and
     matmul[int8 operand]: codes of an int8 bank with per-slice scales),
     against its plain PyTorch version on the card, at the shapes
     full-width bert-large gives it and at ragged shapes: max abs error and
     tolerance, kernel / plain / library ms, and the least time the card
     could take (bytes over 3.35 TB/s, or operations over the peak of their
     type -- 989 TFLOP/s for the bf16 tensor cores, which also run the
     int8 codes widened to bf16, 67 TFLOP/s for fp32 -- whichever is
     larger), the SMW kernels' achieved GB/s and share of their bound at
     each shape (fused_block_smw also at r = 1, as the staleness-1 paths
     launch it) and a second call of each required to give the same bits;
     matmul, fused_precond and their int8 variants on both GEMM
     cores (the Hopper core of wgmma_gemm.cuh where the route sends them,
     the WMMA core of gemm.cuh forced), each launch's core read from the
     per-core counts, with TFLOP/s and the share of the bf16 peak, the
     Hopper core required faster at each bert-large shape; matvec and
     rank1_update (on no path) at d = 1024, 4096 and 1001, beside torch.mv
     and torch.addr, also by device time (the profiler's kernel
     durations) from a cold L2 (after a 128 MB write; and after the write
     and a 128 MB read) and a warm one, with the share of the bound; the
     plain block route's mid-matrix solve (``solve_mid``, which a CUDA
     graph can hold) against ``torch.linalg.solve`` and float64 at the
     bert-large banks; then the SMW kernels and fused_precond on what a
     quarantined bucket hands them on the step its health gate rejects
     (an Inf in one slice of J or of a factor, an Inf int8 scale, a NaN
     window row): each launch returns, the poison stays in its slice;
     and fused_block_smw on a finite J that is not positive definite
     (−10·I) with a full window of equal unit rows: the pivot of that
     slice NaN (the plain route's and the reference's Cholesky fail
     there), the others and the update as the plain route's; the SMW
     kernels and their int8 bodies on the owned chunk of a data-parallel
     rank whose tail is zero padding (5 slices of 1024² at world 2): the
     real slices as the full-bank launch's, the padded slot zero; and
     fused_precond and its int8 body required to give the same bits on a
     second call (ΣG² and ΣΔ² in a fixed order), with their times beside
     the atomic version's (ATOMICS_MS); then the model zoo's shapes
     (ZOO_SMW_DIMS, ZOO_GEMM_DIMS): the four SMW bodies (bf16 and int8,
     rank 1 and block rank 4) on 2-slice banks at d = 24576, 16384, 14336
     and 8960, fused_precond and matmul on starcoder2's and gemma2's MLP
     GEMMs, each against its plain version, a second call for the same
     bits, and timed beside its bound (``further_ms`` of the kernel line);
  4. full-width bert-large (24 layers, random weights from seed 0, batch 8
     x 128) trained with mkor(lamb) through the kernels on six paths (and
     with LAMB alone, with mkor_h(lamb), with the health sentinel, in the
     per-layer layout and with Eva; KFAC and SNGD on an autoencoder; the
     model zoo on path q), each with the launch counts set to 0 just
     before it and read just after:
     a. rank 1, staleness 0 (inv_freq 3): step 0 against the plain route
        from the same state (banks, update, loss after the step), then 6
        steps with losses, step time, peak memory (also over the steps
        after a path's last compared step), launches and fallbacks,
        a profiler breakdown and phase times of one more step;
     b. block rank 4 (inv_freq 4, stagger), 8 steps: every bucket consumes
        a partial and a full window; at each bucket's first full window
        the banks after the kernel update against the plain route from
        the same state; profiler breakdown and phase times of a step;
     c. staleness 1 at rank 1 (inv_freq 3), 9 steps: precompute runs
        before each forward pass, every tick's launched banks against the
        plain route from the same state, and every bucket's promoted
        active bank leaves the identity; profiler breakdown and phase
        times of a step;
     d.-f. the same three schedules with int8 factor state
        (factor_quant="int8": int8 codes, per-slice scales and fp32 error
        feedback) through the int8 kernels -- rank 1 (inv_freq 3, 6
        steps), rank 4 (inv_freq 4, 8 steps) and staleness 1 (inv_freq 3,
        9 steps) -- each bucket's first inversion (first launching tick
        with a non-empty window) held against the plain route from the
        same state, its block update evaluated in float64, on the
        reconstructed fp32 bank decode(codes) + error feedback, with codes
        at most one step apart; the kernel route decodes no bank (only
        window rows);
     g. LAMB alone, no MKOR (6 steps), the step MKOR's overhead is
        measured against;
     h. MKOR-H (mkor_h(lamb), rank 1, inv_freq 3, min steps 3, threshold
        1), 12 steps: the switch must turn off at count 4; every step up
        to it launches fused_smw, fused_precond and matmul, every step
        after it (the eager step reads the switch) none of REPLACES; the
        banks bit-frozen over two inv_freq windows; a profiled post-flip
        step; its final (params, state) saved as a checkpoint into a
        temporary directory and restored onto the card, every leaf
        torch.equal (bytes, save and restore seconds);
     i. the numerical-health sentinel (health=True) at block rank 4
        (inv_freq 4), 18 steps through chaos.chaotic: an Inf into the
        bank of the phase-2 bucket on its phase step 2 (the kernel gets
        the poisoned bank, the gate discards its result), NaN into a
        gradient of the phase-0 bucket at count 5 and an Inf into the
        bank of the phase-1 bucket at count 6 (both off-phase).  Step 0
        against the same step without the sentinel from the same state
        (banks and windows torch.equal, params and LAMB's moments within
        replay_tol); after every step each bucket's (trips, cooldown) as
        the host expects (each trip on its step and bucket only, the
        cooldown counting down on phase steps); after each injected step
        the target's banks the exact identity, its windows and counts
        zero; each target's first inversion after its cooldown held
        against the plain route from the same state, its banks leaving
        the identity; fused_block_smw's pivot of every phase step (min
        over the clean ones at least health_pivot_tol); every loss and
        parameter finite;
     j. the same with int8 factor state at rank 1 (inv_freq 3, 15 steps,
        NaN into a gradient of the phase-0 bucket at count 4): the reset
        is codes 127·I, scales 1/127 and error feedback 0, bit for bit;
     k. the per-layer layout (layout="per_layer", the reference's oracle
        for the banks) at rank 1 (inv_freq 3) through the per-layer
        kernel entries, 6 steps: after each step the bank path's step
        from the same state (the factors carried across), its factors
        torch.equal where they match, else within the bf16 bound (which
        held is printed), params and LAMB's moments within replay_tol;
        fused_precond launched twice as often as on path a (6 layer paths
        in 3 buckets); then captured like the paths of phase 5;
     l. the per-layer layout at block rank 4 with staleness 1 (inv_freq
        4), 8 steps: precompute before each forward pass, every tick's
        launched factors against the plain route from the same state;
     m. Eva (eva(lamb)) through launch/train.py --optimizer eva, 4 steps
        eagerly and in two chunks of 2 (graph replays): finite losses, no
        kernel of REPLACES; the first step's seen flags (false, then
        true) and two layers' preconditioned gradients against the
        float64 dense (vvᵀ + μI)⁻¹ product; Eva's step eager and captured;
     n. KFAC (inv_freq 3) and SNGD (μ 0.3) on the baseline_net
        autoencoder (d_in 768, hidden 256/64/256, N = 1024 rows), 6 steps
        each: every KFAC inversion against float64 torch.linalg.inv,
        SNGD's first step against the dense float64 (F + NμI)⁻¹ at the
        layers of width 256 x 64, no kernel of REPLACES;
     o. data parallel (training/loop.py make_dist_train_step, MKOR with
        dist): o1, an NCCL group of one rank (rank 1, inv_freq 3), 6
        eager steps with the bit-tight stat payload, each held against
        the single-device step from the same state (params, whole state
        and metrics torch.equal, else the leaf and its difference printed
        and a failure); 6 eager steps with the default bf16 payload; then
        captured in chunks of 3 like the paths of phase 5, and the
        captured dist step in turns with the captured single-device step
        (dist, single, single, dist); o3, launch/train.py --dist as a
        user runs it (LAUNCH_DIST): one NCCL rank spawned by the
        launcher, in chunks of 3, and two spawned gloo ranks on the one
        card at --chunk 1 with a closing checkpoint ("world": 2 in its
        metadata), each one's logged losses within LAUNCH_DIST_RTOL of
        the launcher without --dist; o2, two processes on the one card
        over gloo (this script with --dist-rank, each rank's output to a
        file), bert-large cut to TWO_RANK_LAYERS = 8 layers, bf16 rank 1
        (inv_freq 3, 4 steps), int8 rank 4 (inv_freq 4, 5) and bf16
        staleness 1 (inv_freq 3, 7): after every step each rank's launches (the SMW
        kernel twice for each phase bucket, each on the rank's owned
        chunk, as the launch's slice count shows; fused_precond on every
        bucket), int8 error feedback zero, every leaf's fingerprint (two
        64-bit sums of its bits) equal across the ranks, and on phase
        steps rank 0's gathered banks against the single-device optimizer
        on the same inputs from the same state (torch.equal, else the bf16
        bound, printed; int8 codes and scales equal); after each run every
        leaf of both ranks torch.equal through the group; each rank's
        peak memory;
     p. elastic fault tolerance (training/resilience.py, the launcher's
        --elastic): p1, launch/train.py --elastic --dist --dist-devices 1
        as a user runs it (a process of its own; rank 1, inv_freq 3,
        chunks of 3, 9 steps): with --chaos drop_collective@4 --log-json
        its losses float for float the launcher's without --elastic and
        chaos, one retry line; with --ckpt-dir and SIGTERM to the launcher
        as soon as its first chunk's lines come, exit 0, the preemption
        line and an emergency checkpoint at the next unconsumed step, and
        a rerun from it ending on the uninterrupted run's losses bit for
        bit; the launcher's captured step with --elastic (no donation)
        against without, in turns (elastic, plain, plain, elastic), with
        each runner's peak memory; p3, the launcher's make_runner twice as
        a remap rebuilds, the first released before the second captures:
        the second's peak reserved memory within REBUILD_SLACK_GIB of the
        first's, its replays each against the eager step; p2, two gloo
        ranks on the one card (this script with --elastic-rank), bert-large
        cut to 8 layers, staleness 1 and the sentinel through
        kill_shard@3:1,drop_collective@4 at --chunk 1: both ranks' events
        equal, the reset buckets orphaned_buckets on the old map with
        banks the identity, windows zero and cooldown armed, equal on both
        ranks, every SMW launch on the owned chunk (half, then all of the
        slices), the replicas' fingerprints equal every step, and the
        step after the kill's tick launches and banks torch.equal to the
        single-device kernel tick from the same quarantined state;
     q. the model zoo at full width (random weights from seed 0, batch 8
        x 128 text tokens, mkor at rank 1, inv_freq 3, through the
        kernels; ZOO_CUTS): q1, qwen2-moe-a2.7b cut to 2 layers (1.77 B
        params; n_repeats 2): step 0 against the plain route from the
        same state, 6 eager steps with exactly one extra-dims fallback a
        step for each expert bucket (ALLOWED_FALLBACKS), the eager step
        twice from one state (every leaf's fingerprint equal), a profiled
        step with phase times, then captured through the chunk runner in
        chunks of 3 (every replay's fingerprints equal to the eager step
        of its count, run first while the state waits on the host: the
        card cannot hold a second state beside the graph pool) and
        replays alone; q2, every other assigned config cut in depth only
        (two pattern periods; mixtral-8x22b one layer, over SGD: LAMB's
        moments of its 2.9 B params do not fit a step beside its
        gradients; jamba-v0.1-52b .reduced(n_layers=16); whisper-base
        whole), step 0 against the plain route and step 1 twice from one
        state, its fallbacks counted, losses and peak memory;
     each profiled step also lists the host's waits on the device; on
     every path but q's every GEMM of matmul and fused_precond (and of
     their int8 variants) must run on the Hopper core (per-core counts;
     the zoo's ragged and fp32 GEMMs take the WMMA core, printed);
  5. each path of phase 4 captured as CUDA graphs (``rank1[graph]`` ...)
     through the chunk runner (training/loop.py), from its eager run's
     final state, launch counts set to 0 just before and read just after:
     3 x inv_freq steps, so each residue's graph replays twice, and before
     each replay the eager step runs from copies of the same state; the
     replay's params, whole optimizer state and metrics must be
     ``torch.equal`` to it, except, on the kernel paths, the parameters,
     LAMB's moments and the update norm, held to the bound of
     ``replay_tol`` (fused_precond's atomics: the eager step run twice
     from one state differs there too, which is printed); the replays'
     credited launches must cover PATH_KERNELS; then replays alone (step
     times, peak allocated and reserved memory) and a profiled replay;
     rank 1 and LAMB also in turns (eager, captured, captured, eager) and
     as one chunk of 8 replays with one metrics fetch; MKOR-H from a copy
     of its step-0 state in chunks of 3 (the flip inside the second; the
     runner reads the switch once a chunk), every replay held against the
     eager step, the replays of the chunks after the flip's crediting no
     launch of REPLACES, then replays alone before and after the flip,
     and the post-flip captured step in turns with LAMB alone's
     (post-flip, LAMB, LAMB, post-flip); paths i and j from the step-0
     state with their injections in chunks of inv_freq (every replay held
     against the eager step, the health after each replay the eager
     run's, one graph a residue), then without injections: replays alone
     (step times, peak memory with no other runner alive) and a profiled
     replay, and the captured step in turns with the same config without
     the sentinel (path b's, path d's): on, off, off, on;
  6. a summary line per path (eager against captured; MKOR-H also before
     and after the flip, in turns, and its checkpoint; paths i and j the
     sentinel against none, in turns; q2 a line a config), one JSON line
     listing every kernel (launches summed over phases 4 and 5), the
     card's name and power limit, and, last, ``{"ok": true, "device":
     {...}}``.

It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a result when there is no CUDA device or when the port's
sources are not beside it.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
PEAK_FP32_OPS_PER_S = 67e12       # H100 SXM fp32, outside the tensor cores
REPLACES = {
    "fused_smw": "src/repro/kernels/rank1_smw.py:355",
    "fused_precond": "src/repro/kernels/precond.py:108",
    "matmul": "src/repro/kernels/matmul.py:35",
    "fused_block_smw": "src/repro/kernels/rank1_smw.py:294",
    "matvec": "src/repro/kernels/rank1_smw.py:57",
    "rank1_update": "src/repro/kernels/rank1_smw.py:87",
    # the quant bodies of the same three Pallas kernels
    "fused_smw[int8]": "src/repro/kernels/rank1_smw.py:139",
    "fused_block_smw[int8]": "src/repro/kernels/rank1_smw.py:214",
    "fused_precond[int8]": "src/repro/kernels/precond.py:57",
    # the int8 first product of that body (the reference's matmul takes no
    # int8 operand)
    "matmul[int8 operand]": "src/repro/kernels/precond.py:77",
}
SOURCES = {
    "fused_smw": "src/repro_torch/csrc/block_smw.cu",
    "fused_precond": "src/repro_torch/csrc/precond.cu",
    "matmul": "src/repro_torch/csrc/matmul.cu",
    "fused_block_smw": "src/repro_torch/csrc/block_smw.cu",
    "matvec": "src/repro_torch/csrc/rank1_smw.cu",
    "rank1_update": "src/repro_torch/csrc/rank1_smw.cu",
    "fused_smw[int8]": "src/repro_torch/csrc/block_smw.cu",
    "fused_block_smw[int8]": "src/repro_torch/csrc/block_smw.cu",
    "fused_precond[int8]": "src/repro_torch/csrc/precond.cu",
    "matmul[int8 operand]": "src/repro_torch/csrc/matmul.cu",
}
# the peak rate of each kernel's operations: tensor-core GEMMs in bf16
# (int8 codes enter them widened to bf16: there is no int8 x bf16
# product), the SMW kernels' fp32 FMAs on the CUDA cores
PEAK_OPS = {"fused_smw": PEAK_FP32_OPS_PER_S,
            "fused_precond": PEAK_BF16_OPS_PER_S,
            "matmul": PEAK_BF16_OPS_PER_S,
            "fused_block_smw": PEAK_FP32_OPS_PER_S,
            "matvec": PEAK_FP32_OPS_PER_S,
            "rank1_update": PEAK_FP32_OPS_PER_S,
            "fused_smw[int8]": PEAK_FP32_OPS_PER_S,
            "fused_block_smw[int8]": PEAK_FP32_OPS_PER_S,
            "fused_precond[int8]": PEAK_BF16_OPS_PER_S,
            "matmul[int8 operand]": PEAK_BF16_OPS_PER_S}
# fused_precond's time, summed over the bert-large shapes, when it still
# added ΣG² and ΣΔ² with atomics (PERF.md §6: NVIDIA H100 80GB HBM3 at
# 700 W, the run before the fixed-order sums)
ATOMICS_MS = {"fused_precond": 6.173, "fused_precond[int8]": 8.186}
# the kernels each training path must launch (and must not)
_NOT_INT8 = ("fused_smw", "fused_block_smw", "fused_precond", "matmul")
_INT8_GEMMS = ("fused_precond[int8]", "matmul[int8 operand]")
PATH_KERNELS = {
    "rank1": (("fused_smw", "fused_precond", "matmul"), ("fused_block_smw",)),
    "rank4": (("fused_block_smw", "fused_precond", "matmul"), ("fused_smw",)),
    "staleness1": (("fused_block_smw", "fused_precond", "matmul"),
                   ("fused_smw",)),
    "int8_rank1": (("fused_smw[int8]",) + _INT8_GEMMS,
                   _NOT_INT8 + ("fused_block_smw[int8]",)),
    "int8_rank4": (("fused_block_smw[int8]",) + _INT8_GEMMS,
                   _NOT_INT8 + ("fused_smw[int8]",)),
    "int8_staleness1": (("fused_block_smw[int8]",) + _INT8_GEMMS,
                        _NOT_INT8 + ("fused_smw[int8]",)),
    "lamb": ((), tuple(REPLACES)),
    # MKOR-H while its switch is on (after it, nothing of REPLACES)
    "mkor_h": (("fused_smw", "fused_precond", "matmul"),
               ("fused_block_smw",)),
    # the health sentinel with injected faults: rank 4 (its pivot consumed)
    # and int8 rank 1
    "health": (("fused_block_smw", "fused_precond", "matmul"),
               ("fused_smw",)),
    "int8_health": (("fused_smw[int8]",) + _INT8_GEMMS,
                    _NOT_INT8 + ("fused_block_smw[int8]",)),
    # the per-layer layout through the per-layer entries: rank 1, and
    # rank 4 at staleness 1
    "per_layer_rank1": (("fused_smw", "fused_precond", "matmul"),
                        ("fused_block_smw",)),
    "per_layer_rank4_stale1": (("fused_block_smw", "fused_precond",
                                "matmul"), ("fused_smw",)),
    # the baselines reach no Pallas kernel in the reference
    "eva": ((), tuple(REPLACES)),
    "baselines": ((), tuple(REPLACES)),
    # data parallel: world 1 over NCCL (bit-tight and bf16 payloads), and
    # two ranks over gloo, each on its owned chunks
    "dist_w1": (("fused_smw", "fused_precond", "matmul"),
                ("fused_block_smw",)),
    "dist_w1_bf16": (("fused_smw", "fused_precond", "matmul"),
                     ("fused_block_smw",)),
    "dist_w2_rank1": (("fused_smw", "fused_precond", "matmul"),
                      ("fused_block_smw",)),
    "dist_w2_int8_rank4": (("fused_block_smw[int8]",) + _INT8_GEMMS,
                           _NOT_INT8 + ("fused_smw[int8]",)),
    "dist_w2_staleness1": (("fused_block_smw", "fused_precond", "matmul"),
                           ("fused_smw",)),
    # elastic: p1's captured steps with and without --elastic and p3's
    # rebuilt runner (rank 1), p2's two ranks through a kill (staleness 1)
    "elastic_p1": (("fused_smw", "fused_precond", "matmul"),
                   ("fused_block_smw",)),
    "elastic_p2": (("fused_block_smw", "fused_precond", "matmul"),
                   ("fused_smw",)),
    # the model zoo (path q): qwen2-moe-a2.7b at rank 1, eager and
    # captured, and each other assigned config's step 0 and step 1
    "qwen2_moe": (("fused_smw", "fused_precond", "matmul"),
                  ("fused_block_smw",)),
    "zoo": (("fused_smw", "fused_precond", "matmul"), ("fused_block_smw",)),
    # a config whose every bucket has extra dims (mixtral at one layer:
    # n_repeats 1) preconditions through the extra-dims route alone
    "zoo_extra": (("fused_smw", "matmul"), ("fused_block_smw",
                                            "fused_precond")),
}
# the fallbacks a path may take: the zoo's expert buckets (and, at one
# layer, every bucket) take fused_precond's extra-dims route, once a step
# for each such bucket (its count is held to that); no other path takes any
ZOO_PATHS = ("qwen2_moe", "zoo", "zoo_extra")
ALLOWED_FALLBACKS = {name: (("fused_precond", "extra_dims"),)
                     for name in ZOO_PATHS}
# the paths whose GEMMs all run on the Hopper core: every one (bf16
# factors, and int8 codes widened to bf16 in shared memory) but the zoo's,
# whose ragged widths (the router's 60 experts) and fp32 gradients take
# the WMMA core where gemm_route sends them (printed, not forced)
WGMMA_PATHS = tuple(k for k in PATH_KERNELS if k not in ZOO_PATHS)
# the SMW kernels: one persistent launch each, bound by bytes
SMW_KERNELS = ("fused_smw", "fused_block_smw", "fused_smw[int8]",
               "fused_block_smw[int8]")
# the GEMM kernels: matmul counts one GEMM a launch, fused_precond two
GEMM_KERNELS = ("matmul", "matmul[int8 operand]", "fused_precond",
                "fused_precond[int8]")
TRAIN_STEPS = 6                   # rank 1: two full inv_freq=3 windows
RANK4_STEPS = 8                   # rank 4, inv_freq 4: two windows a bucket
STALE_STEPS = 9                   # staleness 1, inv_freq 3: three ticks
LAMB_STEPS = 6                    # plain LAMB, eager
TURN_STEPS = 6                    # steps in each turn (the first is dropped)
HYBRID_STEPS = 12                 # MKOR-H, eager and captured
HYBRID_FLIP = 4                   # min steps 3, threshold 1: off at count 4
HYBRID_CHUNK = 3                  # captured: the flip inside chunk 2
HEALTH_STEPS = 18                 # path i: every injected bucket re-enters
INT8_HEALTH_STEPS = 15            # path j: likewise
PER_LAYER_STEPS = 6               # path k: two full inv_freq=3 windows
PER_LAYER4_STEPS = 8              # path l: rank 4, staleness 1, inv_freq 4
EVA_STEPS = 4                     # path m: eager, and two chunks of 2
BASELINE_STEPS = 6                # path n: KFAC and SNGD, each
DIST_STEPS = 6                    # path o1: world 1, rank 1, inv_freq 3
# path o2: two ranks on the one card, each run's MKORConfig fields (inv_freq
# 3 unless given) and steps: at rank 1 one bucket's phase twice (its second
# inversion from a factor off the identity); at rank 4 every bucket's first
# window and one bucket's second; at staleness 1 each bucket's launch,
# promote and relaunch
DIST_RUNS = {
    "dist_w2_rank1": (dict(), 4),
    "dist_w2_int8_rank4": (dict(rank=4, inv_freq=4, factor_quant="int8"), 5),
    "dist_w2_staleness1": (dict(staleness=1), 7)}
DIST_TIMEOUT = 600                # seconds for both o2 ranks
# o2 and p2: two gloo ranks on the one card, bert-large cut to this depth
# (full width): gloo stages every collective through the host, 8-11 s a
# step at 24 layers on a slow host
TWO_RANK_LAYERS = 8
# path o3: the launcher's --dist (rank 1, inv_freq 3): NCCL at one rank in
# chunks of 3, then two gloo ranks on the one card at --chunk 1
LAUNCH_DIST = {"nccl": (["--dist-devices", "1", "--chunk", "3"], 6),
               "gloo": (["--dist-devices", "2", "--dist-backend", "gloo",
                         "--chunk", "1"], 3)}
LAUNCH_DIST_RTOL = 2e-3           # its losses against the single-device run
# path p: elastic fault tolerance (training/resilience.py, --elastic).  p1:
# the launcher as a user runs it (one spawned NCCL rank, rank 1, inv_freq 3,
# chunks of 3); its captured step with --elastic (no donation) against
# without, in turns of ELASTIC_TURN_CHUNKS chunks (the first dropped)
ELASTIC_LAUNCH = ["--arch", "bert-large", "--use-kernels", "--chunk", "3",
                  "--inv-freq", "3", "--steps", "9", "--log-every", "1"]
ELASTIC_DIST = ["--dist", "--dist-devices", "1"]
ELASTIC_DROP = "drop_collective@4"
ELASTIC_TURN_CHUNKS = 4
ELASTIC_TIMEOUT = 300             # seconds for a launcher run, or both p2 ranks
# p2: a kill on the card, two gloo ranks at --chunk 1 (TWO_RANK_LAYERS
# layers); the step after the kill is compared
ELASTIC_KILL_STEPS = 7
ELASTIC_KILL_AT = 3
ELASTIC_KILL_CHAOS = f"kill_shard@{ELASTIC_KILL_AT}:1,drop_collective@4"
ELASTIC_KILL_KW = dict(staleness=1, health=True, inv_freq=3)
# p3: the second runner's peak reserved memory over the first runner's
REBUILD_SLACK_GIB = 1.0
# path q, the model zoo at full width (random weights from seed 0, batch 8
# x 128 text tokens, mkor(lamb(1e-3)) at rank 1, inv_freq 3, through the
# kernels).  q1: qwen2-moe-a2.7b cut to two layers (n_repeats 2: its dense
# buckets keep their stack dim), 6 eager steps, then captured.  q2: every
# other assigned config, cut in depth only to two pattern periods, but
# mixtral-8x22b (one layer: two are 5.4 B params, over 65 GB with their
# gradients and LAMB's moments), jamba-v0.1-52b (.reduced(n_layers=16):
# one full-width period holds four 2.8 B-param MoE layers) and whisper-base
# (whole); step 0 against the plain route, step 1 run twice for bits.
ZOO_Q1 = "qwen2-moe-a2.7b"
# the backend under MKOR: LAMB, but for mixtral at one layer, whose 2.9 B
# params give LAMB 23 GB of fp32 moments, held twice in a step (the old
# and the new), beside its gradients and MKOR's: that step does not fit
# the 80 GB card, so mixtral's MKOR steps run over SGD (no state)
ZOO_BACKEND = {"mixtral-8x22b": "sgd"}
ZOO_STEPS = 6
ZOO_BATCH, ZOO_TEXT = 8, 128
ZOO_CUTS = {"minicpm-2b": {"n_layers": 2}, "stablelm-12b": {"n_layers": 2},
            "starcoder2-15b": {"n_layers": 2}, "pixtral-12b": {"n_layers": 2},
            "rwkv6-3b": {"n_layers": 2}, "gemma2-9b": {"n_layers": 4},
            "whisper-base": {}, "mixtral-8x22b": {"n_layers": 1},
            "jamba-v0.1-52b": {"reduced": 16},
            ZOO_Q1: {"n_layers": 2}}
# phase 3 at the zoo's factor dims: (bank, d) for the SMW kernels, the
# largest (starcoder2's 24576, mixtral's 16384, gemma2's and pixtral's
# 14336) and a ragged one (rwkv6's 8960); (bank, d_in, d_out) for
# fused_precond and matmul (starcoder2's MLP, both ways, and gemma2's in)
ZOO_SMW_DIMS = ((2, 24576), (2, 16384), (2, 14336), (2, 8960))
ZOO_GEMM_DIMS = ((2, 6144, 24576), (2, 24576, 6144), (2, 3584, 14336))
# each path's numbers for the closing summary lines
SUMMARY = collections.defaultdict(dict)


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stream_rate(n_bytes: float, ms: float, bms: float) -> str:
    """A bytes-bound kernel's achieved rate (the bytes its bound counts
    over its time) and the share of its bound it reaches."""
    return (f"{n_bytes / ms / 1e6:.1f} GB/s, {100 * bms / ms:.1f} % of the "
            "bound")


def require_repeatable(torch, fn, first, tag):
    """A second call on the same inputs must give the same bits (the SMW
    kernels sum S in a fixed order)."""
    again = fn()
    torch.cuda.synchronize()
    a = again[0] if isinstance(again, tuple) else again
    f = first[0] if isinstance(first, tuple) else first
    require(bool(torch.equal(a, f)), f"{tag}: a second call on the same "
            "inputs gave other bits")


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class KernelRow:
    """Accumulates one kernel's numbers over the shapes it is checked at:
    times and bounds summed over the bert-large main-path shapes (one
    call each), the error maxed over every shape."""

    def __init__(self, name: str):
        self.name, self.err = name, 0.0
        self.ms = self.plain_ms = self.bytes = self.ops = 0.0
        self.library_ms = None
        # further timings at the same shapes, printed beside the row
        self.other_ms = collections.defaultdict(float)

    def add(self, err, ms=None, plain_ms=None, n_bytes=0.0, n_ops=0.0,
            library_ms=None):
        self.err = max(self.err, err)
        if ms is not None:
            self.ms += ms
            self.plain_ms += plain_ms
            self.bytes += n_bytes
            self.ops += n_ops
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms

    def bound(self, n_bytes, n_ops):
        return bound_ms(n_bytes, n_ops, PEAK_OPS[self.name])

    def as_json(self, launches: int):
        b_ms, b_by = self.bound(self.bytes, self.ops)
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name], "replaces": REPLACES[self.name],
                "launches": launches, "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": self.library_ms,
                "further_ms": dict(self.other_ms)}


def bf16_close(got, want, rel=2.0 ** -7, floor=1e-5):
    """(max abs error, worst ratio to the elementwise tolerance
    rel·|want| + floor·max|want|).

    For bf16 outputs (the defaults): kernel and plain version round the
    same fp32 value to bf16, but their fp32 sums run in another order, so
    an element may land on the neighbouring bf16 value: one ulp, at most
    2^-7 of the element itself.  The floor 1e-5·max|want| covers elements
    near zero, whose fp32 rounding differences are ~1e-7 of the largest
    entry.  Being elementwise, the bound sees the rank-1 (rank-r) term of
    an SMW update even where it is small beside the diagonal.  fp32
    outputs pass a tighter (rel, floor)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = rel * want.abs() + floor * want.abs().max()
    return diff.max().item(), (diff / tol).max().item()


def near_identity(torch, b, d, gen, dtype):
    """A bank of well-conditioned symmetric factors, like MKOR's inverses."""
    x = torch.randn((b, d, d), generator=gen, device="cuda") * (0.5 / d)
    return (torch.eye(d, device="cuda") + x + x.transpose(1, 2)).to(dtype)


# ----------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# ----------------------------------------------------------------------- #
def check_fused_smw(torch, rows):
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_smw"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, d, main in [(96, 1024, True), (24, 1024, True), (24, 4096, True),
                       (3, 1001, False)]:
        j = near_identity(torch, b, d, gen, torch.bfloat16)
        # v ~ N(0, 1): s = vᵀJv ≈ d and the rank-1 term coef·uuᵀ is ~1/d
        # an element, beside off-diagonal entries of J of ~0.7/d, so a
        # kernel that drops or misweights it fails the elementwise bound
        v = torch.randn((b, d), generator=gen, device="cuda")
        for variant in ("paper", "exact_smw"):
            got = rk.fused_smw(j, v, gamma=0.9, variant=variant)
            want = rk.fused_smw_plain(j, v, gamma=0.9, variant=variant)
            torch.cuda.synchronize()
            err, ratio = bf16_close(got, want)
            print(f"fused_smw {b}x{d}x{d} {variant}: max_abs_err {err:.3e}, "
                  f"worst |got-want| / (2^-7|want| + 1e-5 max|want|) "
                  f"{ratio:.3f} (tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"fused_smw {b}x{d} {variant} disagrees with its plain "
                    "version")
            require_repeatable(torch, lambda: rk.fused_smw(
                j, v, gamma=0.9, variant=variant), got,
                f"fused_smw {b}x{d} {variant}")
            row.add(err)
        if main:
            ms = time_ms(torch, lambda: rk.fused_smw(j, v, gamma=0.9))
            plain = time_ms(torch, lambda: rk.fused_smw_plain(j, v,
                                                              gamma=0.9))
            n_bytes = b * (2 * d * d * 2 + d * 4)
            n_ops = b * 4.0 * d * d
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_smw {b}x{d}x{d}: {ms:.4f} ms, plain {plain:.4f} ms,"
                  f" bound {bms:.4f} ms ({by}); "
                  f"{stream_rate(n_bytes, ms, bms)}")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del j, v


def rate(n_ops, ms):
    """TFLOP/s and the share of the bf16 tensor-core peak."""
    tf = n_ops / ms / 1e9
    return f"{tf:.1f} TFLOP/s ({100 * tf * 1e12 / PEAK_BF16_OPS_PER_S:.1f} % of peak)"


def expect_cores(torch, fn, want_counts, want_cores, tag):
    """Run ``fn`` with the counts at 0 and require its kernel launches and
    the GEMM cores they ran on."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts, cores = ops.launch_counts(), ops.gemm_core_counts()
    require(counts == want_counts and cores == want_cores,
            f"{tag}: launches {counts}, GEMM cores {cores}; expected "
            f"{want_counts}, {want_cores}")
    return out


def check_fused_precond(torch, rows):
    """fused_precond on the core its route picks -- the Hopper core (TMA +
    wgmma, T as a bf16 hi/lo pair) at the bert-large shapes and at ragged
    shapes TMA takes, the WMMA core at (3, 1001, 600) -- and, at the
    bert-large shapes, on the WMMA core forced, each against the plain
    version, rescale on and off.  Timed at the bert-large shapes: both
    cores, the plain version, and a yardstick of two torch.bmm plus the
    norms (T rounded to bf16 between them: a cheaper function, not
    library_ms)."""
    from repro_torch.kernels import precond as pc
    row = rows["fused_precond"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, di, do, main in [(96, 1024, 1024, True), (24, 1024, 4096, True),
                            (24, 4096, 1024, True), (2, 1000, 712, False),
                            (2, 712, 1000, False), (3, 64, 136, False),
                            (3, 1001, 600, False)]:
        r = near_identity(torch, b, di, gen, torch.bfloat16)
        l = near_identity(torch, b, do, gen, torch.bfloat16)
        g = (torch.randn((b, di, do), generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        route = pc.precond_route(r.dtype, g.dtype, l.dtype, di, do,
                                 r.data_ptr(), g.data_ptr(), l.data_ptr())
        require(route == ("wmma" if di % 8 or do % 8 else "wgmma"),
                f"fused_precond {b}x{di}x{do}: route {route}")
        for core in (None, "wmma") if main else (None,):
            for rescale in (True, False):
                got = expect_cores(
                    torch, lambda: pc.fused_precond(r, g, l, rescale=rescale,
                                                    core=core),
                    {"fused_precond": 1, "matmul": 1}, {core or route: 2},
                    f"fused_precond {b}x{di}x{do}")
                want = pc.fused_precond_plain(r, g, l, rescale=rescale)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                # the float32 intermediate rides the tensor cores as a
                # bf16 hi/lo pair (16 significant bits) and sums run in
                # another order: 2e-4 of the largest entry
                tol = 2e-4 * want.abs().max().item()
                print(f"fused_precond {b}x{di}x{do} rescale={rescale} "
                      f"[{core or route}]: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e})")
                require(math.isfinite(err) and err <= tol,
                        f"fused_precond {b}x{di}x{do} [{core or route}] "
                        "disagrees with its plain version")
                # ΣG² and ΣΔ² run in a fixed order: the same bits again
                require_repeatable(torch, lambda: pc.fused_precond(
                    r, g, l, rescale=rescale, core=core), got,
                    f"fused_precond {b}x{di}x{do} [{core or route}]")
                row.add(err)
                del got, want
        if main:
            ms = time_ms(torch, lambda: pc.fused_precond(r, g, l))
            old = time_ms(torch, lambda: pc.fused_precond(r, g, l,
                                                          core="wmma"))
            plain = time_ms(torch, lambda: pc.fused_precond_plain(r, g, l))

            def yardstick():
                if do >= di:
                    d = torch.bmm(r, torch.bmm(g, l), out_dtype=torch.float32)
                else:
                    d = torch.bmm(torch.bmm(r, g), l, out_dtype=torch.float32)
                gn = torch.linalg.vector_norm(g, dim=(1, 2), dtype=torch.float32)
                dn = torch.linalg.vector_norm(d, dim=(1, 2))
                return d * (gn / dn.clamp(min=1e-30))[:, None, None]
            yard = time_ms(torch, yardstick)
            n_bytes = b * ((di * di + do * do + di * do) * 2 + di * do * 4)
            n_ops = b * 2.0 * di * do * (di + do)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_precond {b}x{di}x{do}: wgmma core {ms:.4f} ms "
                  f"{rate(n_ops, ms)}; wmma core {old:.4f} ms "
                  f"{rate(n_ops, old)}; plain {plain:.4f} ms; yardstick "
                  f"(two bf16 torch.bmm + norms, T rounded to bf16) "
                  f"{yard:.4f} ms; bound {bms:.4f} ms ({by})")
            require(ms < old, f"fused_precond {b}x{di}x{do}: the wgmma core "
                    f"({ms:.4f} ms) is not faster than the wmma core "
                    f"({old:.4f} ms)")
            row.add(0.0, ms, plain, n_bytes, n_ops)
            row.other_ms["wmma core"] += old
            row.other_ms["two torch.bmm + norms"] += yard
        del r, l, g


def library_matmul(torch, a, w):
    """The one PyTorch call that computes matmul's function: bf16 inputs,
    fp32 output (``torch.bmm(..., out_dtype=float32)`` where this torch
    has it; else the bf16-output ``torch.bmm``, and the name says so)."""
    try:
        torch.bmm(a[:1, :16, :16], w[:1, :16, :16], out_dtype=torch.float32)
        return (lambda: torch.bmm(a, w, out_dtype=torch.float32),
                "torch.bmm(out_dtype=float32)")
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.bmm(a, w), "torch.bmm (bf16 out)")


def check_matmul(torch, rows):
    """matmul on the core its route picks (the Hopper core for bf16 rows of
    16-byte multiples, the WMMA core for 1001 x 600 x 701) and, at the
    bert-large shapes, on the WMMA core forced; the Hopper core's hi/lo
    pair epilogue (fused_precond's first product) wherever it runs.  Timed
    at the bert-large shapes: both cores, the plain version, torch.bmm."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.ref import split_hi_lo
    row = rows["matmul"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    # the first products fused_precond hands to matmul at bert-large:
    # G L⁻¹ for the 1024x1024 and 1024x4096 buckets, R⁻¹ G for 4096x1024;
    # then ragged shapes, one batch that wraps the persistent grid
    for b, m, k, n, main in [(96, 1024, 1024, 1024, True),
                             (24, 1024, 4096, 4096, True),
                             (24, 4096, 4096, 1024, True),
                             (2, 1000, 600, 712, False),
                             (3, 64, 96, 136, False),
                             (300, 128, 128, 128, False),
                             (3, 1001, 600, 701, False)]:
        a = (torch.randn((b, m, k), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        w = (torch.randn((b, k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        route = mm.route_of(a, w)
        require(route == ("wmma" if k % 8 or n % 8 else "wgmma"),
                f"matmul {b}x{m}x{k}x{n}: route {route}")
        want = mm.matmul_plain(a, w)
        # bf16 products are exact in fp32: only the summation order differs
        tol = 1e-5 * want.abs().max().item() * math.sqrt(k)
        for core in (None, "wmma") if main else (None,):
            got = expect_cores(torch, lambda: mm.matmul(a, w, core=core),
                               {"matmul": 1}, {core or route: 1},
                               f"matmul {b}x{m}x{k}x{n}")
            err = (got - want).abs().max().item()
            print(f"matmul {b}x{m}x{k}x{n} [{core or route}]: max_abs_err "
                  f"{err:.3e} (tol {tol:.3e})")
            require(math.isfinite(err) and err <= tol,
                    f"matmul {b}x{m}x{k}x{n} [{core or route}] disagrees "
                    "with its plain version")
            row.add(err)
            del got
        if route == "wgmma":
            hi, lo = expect_cores(torch, lambda: mm.matmul_split(a, w),
                                  {"matmul": 1}, {"wgmma": 1},
                                  f"matmul hi/lo {b}x{m}x{k}x{n}")
            err = (hi.float() + lo.float() - want).abs().max().item()
            # hi is the bf16 rounding of the product: one bf16 ulp from
            # split_hi_lo of the plain product at most, where the two fp32
            # sums straddle a rounding boundary
            ulp, _ = bf16_close(hi, split_hi_lo(want)[0])
            bad = ((hi.float() - split_hi_lo(want)[0].float()).abs()
                   > 2.0 ** -7 * want.abs() + tol).sum().item()
            print(f"matmul hi/lo {b}x{m}x{k}x{n}: |hi + lo - want| max "
                  f"{err:.3e} (tol {tol:.3e}); hi vs bf16(want) max "
                  f"{ulp:.3e}, {bad} beyond one ulp (tol 0)")
            require(math.isfinite(err) and err <= tol and bad == 0,
                    f"matmul hi/lo {b}x{m}x{k}x{n} disagrees with "
                    "split_hi_lo of the plain product")
            row.add(err)
            del hi, lo
        if main:
            ms = time_ms(torch, lambda: mm.matmul(a, w))
            old = time_ms(torch, lambda: mm.matmul(a, w, core="wmma"))
            plain = time_ms(torch, lambda: mm.matmul_plain(a, w))
            lib_fn, lib_name = library_matmul(torch, a, w)
            lib = time_ms(torch, lib_fn)
            n_bytes = b * ((m * k + k * n) * 2 + m * n * 4)
            n_ops = b * 2.0 * m * k * n
            bms, by = row.bound(n_bytes, n_ops)
            print(f"matmul {b}x{m}x{k}x{n}: wgmma core {ms:.4f} ms "
                  f"{rate(n_ops, ms)}; wmma core {old:.4f} ms "
                  f"{rate(n_ops, old)}; plain {plain:.4f} ms; {lib_name} "
                  f"{lib:.4f} ms {rate(n_ops, lib)}; bound {bms:.4f} ms "
                  f"({by})")
            require(ms < old, f"matmul {b}x{m}x{k}x{n}: the wgmma core "
                    f"({ms:.4f} ms) is not faster than the wmma core "
                    f"({old:.4f} ms)")
            row.add(0.0, ms, plain, n_bytes, n_ops, library_ms=lib)
            row.other_ms["wmma core"] += old
        del a, w, want


def check_fused_block_smw(torch, rows):
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_block_smw"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    # (bank, d, r, dtype, window fills, with_pivot, main-path shape): the
    # three bert-large bank sides at rank 4 with full windows, one of them
    # with the pivot, one with windows filled to 0, 1 and r; then a ragged
    # shape in both dtypes with mixed fills
    cases = [(96, 1024, 4, torch.bfloat16, "full", False, True),
             (24, 1024, 4, torch.bfloat16, "full", True, True),
             (24, 4096, 4, torch.bfloat16, "full", False, True),
             (24, 1024, 4, torch.bfloat16, "mixed", False, False),
             (3, 1001, 3, torch.float32, "mixed", True, False),
             (3, 1001, 3, torch.bfloat16, "mixed", False, False)]
    for b, d, r, dtype, fill, pivot, main in cases:
        j = near_identity(torch, b, d, gen, dtype)
        # v ~ N(0, 1): the rank-r term U M Uᵀ is ~r/d an element, beside
        # off-diagonal entries of J of ~0.7/d, so a kernel that drops or
        # misweights it fails the elementwise bound
        v = torch.randn((b, r, d), generator=gen, device="cuda")
        n = torch.full((b,), r, device="cuda") if fill == "full" else \
            torch.tensor([(0, 1, r)[i % 3] for i in range(b)], device="cuda")
        sq, gm = block_weights(n, r, 0.9)
        vt = (v * sq[..., None]).contiguous()
        # fp32 out: the same fp32 values, summed in another order and
        # solved by Gauss-Jordan in place of LU: 1e-5 relative, floor
        # 1e-6 of the largest entry
        rel, floor = (2.0 ** -7, 1e-5) if dtype == torch.bfloat16 else \
            (1e-5, 1e-6)
        for variant in ("paper", "exact_smw"):
            res = rk.fused_block_smw(j, vt, gm, variant=variant,
                                     with_pivot=pivot)
            want = rk.fused_block_smw_plain(j, vt, gm, variant=variant,
                                            with_pivot=pivot)
            torch.cuda.synchronize()
            got = res[0] if pivot else res
            err, ratio = bf16_close(got, want[0] if pivot else want, rel,
                                    floor)
            tag = (f"fused_block_smw {b}x{d}x{d} r={r} {str(dtype)[6:]} "
                   f"fill={fill} {variant}")
            print(f"{tag}: max_abs_err {err:.3e}, worst |got-want| / "
                  f"({rel:.3g}|want| + {floor:g} max|want|) {ratio:.3f} "
                  "(tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{tag} disagrees with its plain version")
            if fill == "mixed":
                empty = n == 0
                require(bool(torch.equal(got[empty], j[empty])),
                        f"{tag}: an empty window changed its slice")
            require_repeatable(torch, lambda: rk.fused_block_smw(
                j, vt, gm, variant=variant, with_pivot=pivot), res, tag)
            if pivot:
                # Gauss-Jordan pivots against the plain version's squared
                # Cholesky diagonal: the same fp32 numbers, 1e-3 relative
                p_err = ((res[1] - want[1]).abs()
                         / want[1].abs()).max().item()
                print(f"{tag}: pivot min {res[1].min().item():.6g} vs "
                      f"{want[1].min().item():.6g}, max rel err "
                      f"{p_err:.3e} (tol 1e-3)")
                require(p_err <= 1e-3, f"{tag}: pivot disagrees")
            row.add(err)
        if main:
            ms = time_ms(torch, lambda: rk.fused_block_smw(j, vt, gm))
            plain = time_ms(torch, lambda: rk.fused_block_smw_plain(j, vt,
                                                                    gm))
            n_bytes = b * (2 * d * d * j.element_size() + r * d * 4 + 4)
            n_ops = b * ((4.0 * r + 1) * d * d + 4.0 * r * r * d)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_block_smw {b}x{d}x{d} r={r}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by}); "
                  f"{stream_rate(n_bytes, ms, bms)}")
            row.add(0.0, ms, plain, n_bytes, n_ops)
            # r = 1, as the staleness-1 paths launch it (a 1-row window)
            sq1, gm1 = block_weights(torch.ones((b,), device="cuda"), 1, 0.9)
            vt1 = (v[:, :1] * sq1[..., None]).contiguous()
            got = rk.fused_block_smw(j, vt1, gm1)
            want = rk.fused_block_smw_plain(j, vt1, gm1)
            torch.cuda.synchronize()
            err, ratio = bf16_close(got, want)
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"fused_block_smw {b}x{d} r=1 disagrees with its plain "
                    f"version ({ratio:.3f})")
            row.add(err)
            del got, want
            ms1 = time_ms(torch, lambda: rk.fused_block_smw(j, vt1, gm1))
            n_bytes1 = b * (2 * d * d * j.element_size() + d * 4 + 4)
            bms1, by1 = row.bound(n_bytes1, b * (5.0 * d * d + 4.0 * d))
            print(f"fused_block_smw {b}x{d}x{d} r=1: max_abs_err {err:.3e}, "
                  f"ratio {ratio:.3f} (tol 1); {ms1:.4f} ms, bound "
                  f"{bms1:.4f} ms ({by1}); {stream_rate(n_bytes1, ms1, bms1)}")
            row.other_ms["r=1"] += ms1
            row.other_ms["r=1 bound"] += bms1
        del j, v, vt


def check_zoo_dims(torch, rows):
    """The SMW bodies (bf16 and int8, rank 1 and block rank 4) at the
    zoo's factor dims (ZOO_SMW_DIMS) and fused_precond and matmul at its
    widest GEMMs (ZOO_GEMM_DIMS), each against its plain version with the
    bound of its bert-large check, a second call for the same bits, and
    its time beside its bound, the plain version's and, for matmul,
    torch.bmm's.  Kept apart from the bert-large sums (``further_ms`` of
    the kernel line, per shape)."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import precond as pc
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(29)

    def report(name, shape, fn, plain, n_bytes, n_ops, reps=3, lib=None):
        row = rows[name]
        ms = time_ms(torch, fn, reps=reps, warmup=1)
        p_ms = time_ms(torch, plain, reps=1, warmup=0)
        bms, by = row.bound(n_bytes, n_ops)
        line = (f"{name} {shape}: {ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
        if lib is not None:
            l_ms = time_ms(torch, lib[1], reps=reps, warmup=1)
            line += f", {lib[0]} {l_ms:.4f} ms"
            row.other_ms[f"{shape} {lib[0]}"] = l_ms
        print(line + (f"; {stream_rate(n_bytes, ms, bms)}" if by == "bytes"
                      else f"; {rate(n_ops, ms)}"))
        row.other_ms[shape] = ms
        row.other_ms[f"{shape} plain"] = p_ms
        row.other_ms[f"{shape} bound"] = bms

    def close(name, shape, got, want, rel, floor):
        err, ratio = bf16_close(got, want, rel, floor)
        print(f"{name} {shape}: max_abs_err {err:.3e}, worst |got-want| / "
              f"({rel:.3g}|want| + {floor:g} max|want|) {ratio:.3f} (tol 1)")
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"{name} {shape} disagrees with its plain version")
        rows[name].add(err)

    for b, d in ZOO_SMW_DIMS:
        shape = f"{b}x{d}x{d}"
        j = near_identity(torch, b, d, gen, torch.bfloat16)
        v = torch.randn((b, d), generator=gen, device="cuda")
        got = rk.fused_smw(j, v, gamma=0.9)
        close("fused_smw", shape, got, rk.fused_smw_plain(j, v, gamma=0.9),
              2.0 ** -7, 1e-5)
        require_repeatable(torch, lambda: rk.fused_smw(j, v, gamma=0.9),
                           got, f"fused_smw {shape}")
        del got
        report("fused_smw", shape, lambda: rk.fused_smw(j, v, gamma=0.9),
               lambda: rk.fused_smw_plain(j, v, gamma=0.9),
               b * (2 * d * d * 2 + d * 4), b * 4.0 * d * d)
        r = 4
        vr = torch.randn((b, r, d), generator=gen, device="cuda")
        sq, gm = block_weights(torch.full((b,), r, device="cuda"), r, 0.9)
        vt = (vr * sq[..., None]).contiguous()
        del vr
        got = rk.fused_block_smw(j, vt, gm)
        close("fused_block_smw", f"{shape} r=4", got,
              rk.fused_block_smw_plain(j, vt, gm), 2.0 ** -7, 1e-5)
        require_repeatable(torch, lambda: rk.fused_block_smw(j, vt, gm),
                           got, f"fused_block_smw {shape} r=4")
        del got
        report("fused_block_smw", f"{shape} r=4",
               lambda: rk.fused_block_smw(j, vt, gm),
               lambda: rk.fused_block_smw_plain(j, vt, gm),
               b * (2 * d * d * 2 + r * d * 4 + 4),
               b * ((4.0 * r + 1) * d * d + 4.0 * r * r * d))
        del j
        gc.collect()
        torch.cuda.empty_cache()
        q, sc = int8_bank(torch, b, d, gen)
        got = rk.fused_smw(q, v, gamma=0.9, scale=sc)
        close("fused_smw[int8]", shape, got,
              rk.fused_smw_plain(q, v, gamma=0.9, scale=sc), 1e-5, 1e-6)
        require_repeatable(torch, lambda: rk.fused_smw(
            q, v, gamma=0.9, scale=sc), got, f"fused_smw[int8] {shape}")
        del got
        report("fused_smw[int8]", shape,
               lambda: rk.fused_smw(q, v, gamma=0.9, scale=sc),
               lambda: rk.fused_smw_plain(q, v, gamma=0.9, scale=sc),
               b * (d * d * 1 + d * d * 4 + d * 4 + 4), b * 5.0 * d * d)
        got = rk.fused_block_smw(q, vt, gm, scale=sc)
        close("fused_block_smw[int8]", f"{shape} r=4", got,
              rk.fused_block_smw_plain(q, vt, gm, scale=sc), 1e-5, 1e-6)
        require_repeatable(torch, lambda: rk.fused_block_smw(
            q, vt, gm, scale=sc), got, f"fused_block_smw[int8] {shape}")
        del got
        report("fused_block_smw[int8]", f"{shape} r=4",
               lambda: rk.fused_block_smw(q, vt, gm, scale=sc),
               lambda: rk.fused_block_smw_plain(q, vt, gm, scale=sc),
               b * (d * d * 1 + d * d * 4 + r * d * 4 + 8),
               b * ((4.0 * r + 2) * d * d + 4.0 * r * r * d))
        del q, sc, v, vt
        gc.collect()
        torch.cuda.empty_cache()

    for b, di, do in ZOO_GEMM_DIMS:
        shape = f"{b}x{di}x{do}"
        r = near_identity(torch, b, di, gen, torch.bfloat16)
        l = near_identity(torch, b, do, gen, torch.bfloat16)
        g = (torch.randn((b, di, do), generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        got = pc.fused_precond(r, g, l)
        want = pc.fused_precond_plain(r, g, l)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-4 * want.abs().max().item()
        print(f"fused_precond {shape}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), route {pc.precond_route(r.dtype, g.dtype, l.dtype, di, do, r.data_ptr(), g.data_ptr(), l.data_ptr())}")
        require(math.isfinite(err) and err <= tol,
                f"fused_precond {shape} disagrees with its plain version")
        require_repeatable(torch, lambda: pc.fused_precond(r, g, l), got,
                           f"fused_precond {shape}")
        rows["fused_precond"].add(err)
        del got, want
        report("fused_precond", shape, lambda: pc.fused_precond(r, g, l),
               lambda: pc.fused_precond_plain(r, g, l),
               b * ((di * di + do * do + di * do) * 2 + di * do * 4),
               b * 2.0 * di * do * (di + do))
        # matmul: fused_precond's first product at this shape (G L⁻¹ when
        # d_out <= d_in, else R⁻¹ G)
        a, w = (g, l) if do <= di else (r, g)
        m, k, n = a.shape[1], a.shape[2], w.shape[2]
        got = mm.matmul(a, w)
        want = mm.matmul_plain(a, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item() * math.sqrt(k)
        print(f"matmul {b}x{m}x{k}x{n}: max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), route {mm.route_of(a, w)}")
        require(math.isfinite(err) and err <= tol,
                f"matmul {b}x{m}x{k}x{n} disagrees with its plain version")
        rows["matmul"].add(err)
        del got, want
        lib_fn, lib_name = library_matmul(torch, a, w)
        report("matmul", f"{b}x{m}x{k}x{n}", lambda: mm.matmul(a, w),
               lambda: mm.matmul_plain(a, w),
               b * ((m * k + k * n) * 2 + m * n * 4), b * 2.0 * m * k * n,
               lib=(lib_name, lib_fn))
        del r, l, g, a, w
        gc.collect()
        torch.cuda.empty_cache()


def check_poisoned_kernels(torch):
    """The kernels on what a quarantined bucket hands them on the step its
    health gate rejects (the port runs the inversion and a select discards
    it, where the reference skips it): an Inf in one slice of J (fused_smw
    in bf16 and, through an Inf scale, in int8; fused_block_smw), a NaN
    row in one slice's window (fused_block_smw, with the pivot), an Inf in
    one slice of a factor (fused_precond).  At the bert-large 24 x 1024^2
    bank, each launch must return (a hang stops the script here), write
    non-finite values into the poisoned slice, and leave every other slice
    as the clean launch wrote it: bit for bit, and for fused_precond
    (its ΣΔ² atomics add in another order) within 1e-5 relative."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.core.stats import quant_encode
    from repro_torch.kernels import precond as pc
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, d, r, bad = 24, 1024, 4, 5
    j = near_identity(torch, b, d, gen, torch.bfloat16)
    j_bad = j.clone()
    j_bad[bad, 0, 0] = float("inf")
    q, sc = quant_encode(j.float())
    sc_bad = sc.clone()
    sc_bad[bad] = float("inf")
    v = torch.randn((b, r, d), generator=gen, device="cuda")
    sq, gm = block_weights(torch.full((b,), r, device="cuda"), r, 0.9)
    vt = (v * sq[..., None]).contiguous()
    vt_bad = vt.clone()
    vt_bad[bad, 1] = float("nan")
    v1 = v[:, 0].contiguous()
    g = torch.randn((b, d, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    cases = [
        ("fused_smw, Inf in J", lambda jj: rk.fused_smw(jj, v1, gamma=0.9),
         j, j_bad),
        ("fused_smw[int8], Inf scale",
         lambda ss: rk.fused_smw(q, v1, gamma=0.9, scale=ss), sc, sc_bad),
        ("fused_block_smw, Inf in J",
         lambda jj: rk.fused_block_smw(jj, vt, gm), j, j_bad),
        ("fused_block_smw, NaN window row (pivot)",
         lambda vv: rk.fused_block_smw(j, vv, gm, with_pivot=True), vt,
         vt_bad),
        ("fused_precond, Inf in L",
         lambda ll: pc.fused_precond(j, g, ll), j, j_bad)]
    keep = torch.arange(b, device="cuda") != bad
    for tag, fn, clean, poisoned in cases:
        want = fn(clean)
        t0 = time.perf_counter()
        got = fn(poisoned)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        piv = None
        if isinstance(got, tuple):
            (got, piv), want = got, want[0]
        hit = not bool(torch.isfinite(got[bad]).all())
        if tag.startswith("fused_precond"):
            err, ratio = bf16_close(got[keep], want[keep], 1e-5, 1e-6)
            same = math.isfinite(ratio) and ratio <= 1.0
            detail = f"the other slices within {ratio:.3f} of the bound"
        else:
            same = bool(torch.equal(got[keep], want[keep]))
            detail = f"the other slices bit for bit: {same}"
        if piv is not None:
            p_bad = piv[bad].item()
            p_ok = bool(torch.isfinite(piv[keep]).all())
            detail += (f"; pivot of the poisoned slice {p_bad}, the others "
                       f"finite: {p_ok}")
            same = same and p_ok and not math.isfinite(p_bad)
        print(f"poisoned {tag}: returned in {ms:.3f} ms; slice {bad} "
              f"non-finite: {hit}; {detail}")
        require(hit and same, f"poisoned {tag}: the poison did not stay in "
                "its slice")
        del want, got


def check_owned_chunks(torch):
    """The SMW kernels and their int8 bodies on the owned chunk that the
    data-parallel path hands them when the world does not divide a bank:
    5 slices of 1024² at world 2 give chunks of 3, so rank 1 owns slices
    3 and 4 and one zero-padded slot (a zero factor -- int8: codes and
    scale 0 -- with a zero vector; for the block update a window count of
    0).  The real slices must match the full-bank launch (torch.equal, or
    else the kernel's bound against it, printed), the padded slice must
    come back zero."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(21)
    n, world, d, r = 5, 2, 1024, 4
    chunk = -(-n // world)
    own = n - chunk                          # rank 1's real slices

    def rank1_chunk(x):
        return torch.cat([x[chunk:], x.new_zeros((chunk - own,)
                                                 + tuple(x.shape[1:]))])
    for kind in ("bf16", "int8"):
        if kind == "int8":
            j, sc = int8_bank(torch, n, d, gen)
        else:
            j, sc = near_identity(torch, n, d, gen, torch.bfloat16), None
        v = torch.randn((n, d), generator=gen, device="cuda")
        w = torch.randn((n, r, d), generator=gen, device="cuda")
        cnt = torch.full((n,), r, device="cuda")
        sq, gm = block_weights(cnt, r, 0.9)
        vt = (w * sq[..., None]).contiguous()
        cnt_c = torch.cat([cnt[chunk:], cnt.new_zeros(chunk - own)])
        sq_c, gm_c = block_weights(cnt_c, r, 0.9)
        vt_c = (rank1_chunk(w) * sq_c[..., None]).contiguous()
        sc_c = None if sc is None else rank1_chunk(sc)
        runs = {
            "fused_smw": (lambda: rk.fused_smw(j, v, gamma=0.9, scale=sc),
                          lambda: rk.fused_smw(rank1_chunk(j),
                                               rank1_chunk(v), gamma=0.9,
                                               scale=sc_c)),
            "fused_block_smw": (
                lambda: rk.fused_block_smw(j, vt, gm, scale=sc),
                lambda: rk.fused_block_smw(rank1_chunk(j), vt_c, gm_c,
                                           scale=sc_c))}
        for name, (full_fn, part_fn) in runs.items():
            tag = name + ("[int8]" if kind == "int8" else "")
            full, part = full_fn(), part_fn()
            torch.cuda.synchronize()
            require(bool(torch.isfinite(part.float()).all()) and
                    int(torch.count_nonzero(part[own:])) == 0,
                    f"{tag}: the padded slot of an owned chunk is not zero")
            real, want = part[:own], full[chunk:]
            if torch.equal(real, want):
                how = "torch.equal to the full-bank launch"
            else:
                rel, floor = (2.0 ** -7, 1e-5) if kind == "bf16" else \
                    (1e-5, 1e-6)
                err, ratio = bf16_close(real, want, rel, floor)
                require(math.isfinite(ratio) and ratio <= 1.0,
                        f"{tag}: an owned chunk's real slices differ from "
                        "the full-bank launch")
                how = (f"within the bound of the full-bank launch (max abs "
                       f"err {err:.3e}, ratio {ratio:.3f})")
            print(f"{tag} on an owned chunk of {chunk} slices of {d}^2 "
                  f"({own} real, {chunk - own} zero-padded, world {world}): "
                  f"real slices {how}; padded slot zero")
            del full, part
        del j, v, w, vt, vt_c


def check_non_pd_pivot(torch):
    """fused_block_smw's pivot where the mid matrix is not positive
    definite: at the bert-large 24 x 1024^2 bank (bf16), slice 5 a finite
    J that is not positive definite (−10·I), the others near the
    identity, every slice with a full window of r = 4 equal unit rows.
    The mid matrix of slice 5 then has a negative eigenvalue: its pivot
    must be NaN, as the plain route's Cholesky (and the reference's
    ``smw_block_update(with_pivot=True)``) gives; every other pivot finite
    and within 1e-3 of the plain one; the update finite and within the
    elementwise bf16 bound of the plain route in every slice."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(22)
    b, d, r, bad = 24, 1024, 4, 5
    j = near_identity(torch, b, d, gen, torch.bfloat16)
    j[bad] = (-10.0 * torch.eye(d, device="cuda")).to(torch.bfloat16)
    v = torch.ones((b, r, d), device="cuda") / math.sqrt(d)
    sq, gm = block_weights(torch.full((b,), r, device="cuda"), r, 0.9)
    vt = (v * sq[..., None]).contiguous()
    keep = torch.arange(b, device="cuda") != bad
    for variant in ("paper", "exact_smw"):
        got, piv = rk.fused_block_smw(j, vt, gm, variant=variant,
                                      with_pivot=True)
        want, want_piv = rk.fused_block_smw_plain(j, vt, gm,
                                                  variant=variant,
                                                  with_pivot=True)
        torch.cuda.synchronize()
        err, ratio = bf16_close(got, want)
        p_rel = float(((piv[keep] - want_piv[keep]).abs()
                       / want_piv[keep].abs()).max())
        print(f"non-PD mid matrix ({variant}): pivot of slice {bad} kernel "
              f"{piv[bad].item()}, plain {want_piv[bad].item()}; the other "
              f"pivots within {p_rel:.3e} of the plain ones (tol 1e-3); "
              f"update max_abs_err {err:.3e}, worst ratio {ratio:.3f} "
              "(tol 1)")
        require(math.isnan(piv[bad].item()) and
                math.isnan(want_piv[bad].item()),
                f"non-PD mid matrix ({variant}): the pivot is not NaN")
        require(p_rel <= 1e-3 and bool(torch.isfinite(got).all()) and
                math.isfinite(ratio) and ratio <= 1.0,
                f"non-PD mid matrix ({variant}): pivots or update differ")


L2_FLUSH_BYTES = 128 * 2 ** 20    # scratch for a cold L2: 2.5x the 50 MB


def device_kernels(torch, body):
    """(name, ms) of each device kernel ``body`` launches, from the
    profiler's kernel events: the device's own durations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


class DeviceTimer:
    """Device time of one call, by the kernels' own durations, in three
    states of the L2 cache:

    * ``cold``: each call follows a write of a 128 MB scratch buffer
      (more than twice the L2), so the operands are not in L2, which
      holds the scratch's dirty lines instead;
    * ``cold, clean``: the write, then a read of another 128 MB buffer, so
      the operands are not in L2 and its lines are clean;
    * ``warm``: back-to-back calls, the operands in L2 where they fit.

    The set-up's kernels are told apart from the call's by name (learned
    from a run of each alone) and left out; every set-up runs outside the
    measured kernels."""

    STATES = ("cold", "cold, clean", "warm")

    def __init__(self, torch, reps=20):
        self.torch, self.reps = torch, reps
        n = L2_FLUSH_BYTES // 4
        scratch = torch.empty(n, device="cuda")
        other = torch.ones(n, device="cuda")

        def write():
            scratch.fill_(1.0)

        def write_read():
            scratch.fill_(1.0)
            other.sum()

        self.setups = dict(zip(self.STATES, (write, write_read, None)))
        self.setup_names = set()
        for fn in (write, write_read):
            self.setup_names |= {k for k, _ in device_kernels(torch, fn)}

    def __call__(self, fn, tag):
        """{state: mean device ms of one call of ``fn``}."""
        fn()
        for _ in range(5):      # the profiler may drop the events: see below
            own = collections.Counter(k for k, _ in device_kernels(
                self.torch, fn))
            if own:
                break
            print(f"{tag}: the profiler returned no kernel events; taken "
                  "again")
        require(bool(own) and not set(own) & self.setup_names,
                f"{tag}: kernels {sorted(own)} cannot be told from the "
                f"cold-L2 set-up's {sorted(self.setup_names)}")
        out = {}
        for state, before in self.setups.items():
            def body():
                for _ in range(self.reps):
                    if before is not None:
                        before()
                    fn()
            # the profiler drops some of a trace's kernel events now and
            # then, or all of them: each kernel's time is the mean of the
            # events that came back, and a trace that kept fewer than half
            # of some kernel's, or more than it launched, is taken again,
            # at most four times
            want = {k: self.reps * n for k, n in own.items()}
            for _ in range(5):
                events = device_kernels(self.torch, body)
                got = {k: [t for n, t in events if n == k] for k in own}
                off = {k: len(got[k]) for k in own
                       if not want[k] <= 2 * len(got[k]) <= 2 * want[k]}
                if not off:
                    break
                print(f"{tag}, {state}: the profiler returned {off} kernel "
                      f"events of {want} ({len(events)} in all); taken again")
            require(not off, f"{tag}: kernel events {off} of {want}")
            lost = sum(want[k] - len(got[k]) for k in own)
            if lost:
                print(f"{tag}, {state}: {lost} of {sum(want.values())} "
                      "kernel events missing from the trace; the mean of "
                      "the rest is kept")
            out[state] = sum(own[k] * sum(ts) / len(ts)
                             for k, ts in got.items())
        return out


# the library call each unfused building block is held against
UNFUSED = {"matvec": ("torch.mv", "bf16 vector and output"),
           "rank1_update": ("torch.addr", "bf16 vectors")}


def _device_line(times):
    return (f"{times['cold']:.4f} ms cold ({times['cold, clean']:.4f} "
            f"clean, {times['warm']:.4f} warm)")


def check_solve_mid(torch):
    """The plain block route's mid-matrix solve (``rank1_smw.solve_mid``:
    on CUDA mid⁻¹ from cuBLAS's batched getrs, then one product, which a
    CUDA graph can hold) against ``torch.linalg.solve`` (MAGMA's batched
    getrs, which it cannot) and float64, at the bert-large banks with a
    full rank-4 window: J near the identity, rows v ~ N(0, 1) weighted as
    the block update weights them.  Bound: 1e-5 |want| + 1e-6 max|want|
    against ``solve``, elementwise, on the solve and on the update."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for b, d in ((96, 1024), (24, 1024), (24, 4096)):
        j = near_identity(torch, b, d, gen, torch.float32)
        sq, gm = block_weights(4, 4, 0.9, device=j.device)
        vt = torch.randn((b, 4, d), generator=gen,
                         device="cuda") * sq[:, None]
        u = vt @ j.mT
        mid = gm * gm * torch.eye(4, device="cuda") + gm ** 3 * (vt @ u.mT)
        got, want = rk.solve_mid(mid, u), torch.linalg.solve(mid, u)
        exact = torch.linalg.solve(mid.double(), u.double())
        _, ratio = bf16_close(got, want, 1e-5, 1e-6)
        upd_g = gm * j + u.mT @ got
        upd_w = gm * j + u.mT @ want
        _, upd_ratio = bf16_close(upd_g, upd_w, 1e-5, 1e-6)
        scale = float(exact.abs().max())
        e_got = float((got.double() - exact).abs().max()) / scale
        e_want = float((want.double() - exact).abs().max()) / scale
        print(f"solve_mid {b}x4x{d}: against torch.linalg.solve worst ratio "
              f"{ratio:.3f} on the solve, {upd_ratio:.3f} on the update "
              f"(tol 1); max error / max|x| against float64: solve_mid "
              f"{e_got:.3e}, torch.linalg.solve {e_want:.3e}")
        worst = max(worst, ratio, upd_ratio)
        require(math.isfinite(ratio) and ratio <= 1.0 and upd_ratio <= 1.0,
                f"solve_mid {b}x4x{d} differs from torch.linalg.solve")
    return worst


def check_matvec_and_rank1_update(torch, rows):
    """The two unfused building blocks, at d = 1024, 4096 and 1001 (bf16
    J, fp32 vectors), each call twice for the same bits.  They are on no
    training path.  Timed by device time (:class:`DeviceTimer`) beside
    the call time (events around back-to-back calls), each beside its
    bound, as are ``torch.mv`` and ``torch.addr``; ms, plain, library and
    bound sum the three shapes, the device times go in the rows' further
    timings."""
    from repro_torch.kernels import rank1_smw as rk
    gen = torch.Generator(device="cuda").manual_seed(5)
    timer = DeviceTimer(torch)

    def record(name, d, dev, lib_dev, ms, lib, plain, n_bytes, n_ops, err):
        row = rows[name]
        lib_name, note = UNFUSED[name]
        bms, by = row.bound(n_bytes, n_ops)
        print(f"{name} {d}x{d}: device {_device_line(dev)}; call {ms:.4f} "
              f"ms; bound {bms:.4f} ms ({by}), {100 * bms / dev['cold']:.1f} "
              f"% of it cold, {100 * bms / ms:.1f} % by call; {lib_name} "
              f"({note}) device {_device_line(lib_dev)}, "
              f"call {lib:.4f} ms; plain call {plain:.4f} ms")
        row.add(err, ms, plain, n_bytes, n_ops, library_ms=lib)
        for state in dev:
            row.other_ms[f"device {state}"] += dev[state]
            row.other_ms[f"{lib_name} device {state}"] += lib_dev[state]

    for d in (1024, 4096, 1001):
        j = near_identity(torch, 1, d, gen, torch.bfloat16)[0]
        v = torch.randn((d, 1), generator=gen, device="cuda")
        got = rk.matvec(j, v)
        want = rk.matvec_plain(j, v)
        torch.cuda.synchronize()
        # fp32 out, the same products summed in another order
        err, ratio = bf16_close(got, want, 0.0, 1e-5)
        print(f"matvec {d}x{d}: max_abs_err {err:.3e}, worst |got-want| / "
              f"(1e-5 max|want|) {ratio:.3f} (tol 1)")
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"matvec {d} disagrees with its plain version")
        require_repeatable(torch, lambda: rk.matvec(j, v), got,
                           f"matvec {d}")
        vb = v.to(torch.bfloat16)
        record("matvec", d,
               timer(lambda: rk.matvec(j, v), f"matvec {d}"),
               timer(lambda: torch.mv(j, vb[:, 0]), f"torch.mv {d}"),
               time_ms(torch, lambda: rk.matvec(j, v), reps=50),
               time_ms(torch, lambda: torch.mv(j, vb[:, 0]), reps=50),
               time_ms(torch, lambda: rk.matvec_plain(j, v), reps=50),
               d * d * 2 + 2 * d * 4, 2.0 * d * d, err)

        u = (want / math.sqrt(d)).contiguous()
        coef = torch.full((1, 1), 0.37, device="cuda")
        got = rk.rank1_update(j, u, coef, gamma=0.9)
        want = rk.rank1_update_plain(j, u, coef, gamma=0.9)
        torch.cuda.synchronize()
        err, ratio = bf16_close(got, want)
        print(f"rank1_update {d}x{d}: max_abs_err {err:.3e}, worst "
              f"|got-want| / (2^-7|want| + 1e-5 max|want|) {ratio:.3f} "
              "(tol 1)")
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"rank1_update {d} disagrees with its plain version")
        require_repeatable(torch, lambda: rk.rank1_update(
            j, u, coef, gamma=0.9), got, f"rank1_update {d}")
        ub = u[:, 0].to(torch.bfloat16)
        c = coef.item()
        record("rank1_update", d,
               timer(lambda: rk.rank1_update(j, u, coef, gamma=0.9),
                     f"rank1_update {d}"),
               timer(lambda: torch.addr(j, ub, ub, beta=0.9, alpha=c),
                     f"torch.addr {d}"),
               time_ms(torch, lambda: rk.rank1_update(j, u, coef, gamma=0.9),
                       reps=50),
               time_ms(torch, lambda: torch.addr(j, ub, ub, beta=0.9,
                                                 alpha=c), reps=50),
               time_ms(torch, lambda: rk.rank1_update_plain(
                   j, u, coef, gamma=0.9), reps=50),
               2 * d * d * 2 + d * 4 + 4, 3.0 * d * d, err)
        del j, v


def int8_bank(torch, b, d, gen):
    """int8 codes and (b,) fp32 scales (``quant_encode``) of a near-identity
    fp32 bank with symmetric off-diagonal noise of 0.05, so that the codes
    spread over about ±30 off the diagonal (a bank encoded from the
    phase's bf16 near-identity would hold almost only 127·I)."""
    from repro_torch.core.stats import quant_encode
    x = torch.randn((b, d, d), generator=gen, device="cuda") * 0.05
    x = (x + x.transpose(1, 2)) * (0.5 ** 0.5)
    x.diagonal(dim1=1, dim2=2).add_(1.0)
    q, sc = quant_encode(x)
    del x
    return q, sc


def check_fused_smw_int8(torch, rows):
    """fused_smw on int8 codes (fp32 out) against its plain version, which
    decodes the codes and computes in fp32: the same decoded values summed
    in another order, so the fp32 elementwise bound 1e-5|want| + 1e-6
    max|want|."""
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_smw[int8]"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, d, main in [(96, 1024, True), (24, 1024, True), (24, 4096, True),
                       (3, 1001, False)]:
        q, sc = int8_bank(torch, b, d, gen)
        v = torch.randn((b, d), generator=gen, device="cuda")
        for variant in ("paper", "exact_smw"):
            got = rk.fused_smw(q, v, gamma=0.9, variant=variant, scale=sc)
            want = rk.fused_smw_plain(q, v, gamma=0.9, variant=variant,
                                      scale=sc)
            torch.cuda.synchronize()
            err, ratio = bf16_close(got, want, 1e-5, 1e-6)
            print(f"fused_smw[int8] {b}x{d}x{d} {variant}: max_abs_err "
                  f"{err:.3e}, worst |got-want| / (1e-5|want| + 1e-6 "
                  f"max|want|) {ratio:.3f} (tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"fused_smw[int8] {b}x{d} {variant} disagrees with its "
                    "plain version")
            require_repeatable(torch, lambda: rk.fused_smw(
                q, v, gamma=0.9, variant=variant, scale=sc), got,
                f"fused_smw[int8] {b}x{d} {variant}")
            row.add(err)
            del got, want
        if main:
            ms = time_ms(torch, lambda: rk.fused_smw(q, v, gamma=0.9,
                                                     scale=sc))
            plain = time_ms(torch, lambda: rk.fused_smw_plain(
                q, v, gamma=0.9, scale=sc))
            # the codes read once, the fp32 update written once; one
            # decode a code
            n_bytes = b * (d * d * 1 + d * d * 4 + d * 4 + 4)
            n_ops = b * 5.0 * d * d
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_smw[int8] {b}x{d}x{d}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by}); "
                  f"{stream_rate(n_bytes, ms, bms)}")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del q, sc, v


def check_fused_block_smw_int8(torch, rows):
    """fused_block_smw on int8 codes at rank 4 (the bert-large bank sides,
    one with the pivot and one with windows filled to 0, 1 and r) and at a
    ragged shape; the fp32 bound of check_fused_smw_int8."""
    from repro_torch.core.mkor import block_weights
    from repro_torch.kernels import rank1_smw as rk
    row = rows["fused_block_smw[int8]"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(96, 1024, 4, "full", False, True),
             (24, 1024, 4, "full", True, True),
             (24, 4096, 4, "full", False, True),
             (24, 1024, 4, "mixed", False, False),
             (3, 1001, 3, "mixed", True, False)]
    for b, d, r, fill, pivot, main in cases:
        q, sc = int8_bank(torch, b, d, gen)
        v = torch.randn((b, r, d), generator=gen, device="cuda")
        n = torch.full((b,), r, device="cuda") if fill == "full" else \
            torch.tensor([(0, 1, r)[i % 3] for i in range(b)], device="cuda")
        sq, gm = block_weights(n, r, 0.9)
        vt = (v * sq[..., None]).contiguous()
        for variant in ("paper", "exact_smw"):
            res = rk.fused_block_smw(q, vt, gm, variant=variant,
                                     with_pivot=pivot, scale=sc)
            want = rk.fused_block_smw_plain(q, vt, gm, variant=variant,
                                            with_pivot=pivot, scale=sc)
            torch.cuda.synchronize()
            got = res[0] if pivot else res
            err, ratio = bf16_close(got, want[0] if pivot else want, 1e-5,
                                    1e-6)
            tag = (f"fused_block_smw[int8] {b}x{d}x{d} r={r} fill={fill} "
                   f"{variant}")
            print(f"{tag}: max_abs_err {err:.3e}, worst |got-want| / "
                  f"(1e-5|want| + 1e-6 max|want|) {ratio:.3f} (tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{tag} disagrees with its plain version")
            if fill == "mixed":
                empty = n == 0
                require(bool(torch.equal(
                    got[empty], q[empty].float() * sc[empty][:, None, None])),
                    f"{tag}: an empty window changed its decoded slice")
            require_repeatable(torch, lambda: rk.fused_block_smw(
                q, vt, gm, variant=variant, with_pivot=pivot, scale=sc),
                res, tag)
            if pivot:
                p_err = ((res[1] - want[1]).abs()
                         / want[1].abs()).max().item()
                print(f"{tag}: pivot min {res[1].min().item():.6g} vs "
                      f"{want[1].min().item():.6g}, max rel err "
                      f"{p_err:.3e} (tol 1e-3)")
                require(p_err <= 1e-3, f"{tag}: pivot disagrees")
            row.add(err)
            del res, want, got
        if main:
            ms = time_ms(torch, lambda: rk.fused_block_smw(q, vt, gm,
                                                           scale=sc))
            plain = time_ms(torch, lambda: rk.fused_block_smw_plain(
                q, vt, gm, scale=sc))
            n_bytes = b * (d * d * 1 + d * d * 4 + r * d * 4 + 8)
            n_ops = b * ((4.0 * r + 2) * d * d + 4.0 * r * r * d)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_block_smw[int8] {b}x{d}x{d} r={r}: {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}); "
                  f"{stream_rate(n_bytes, ms, bms)}")
            row.add(0.0, ms, plain, n_bytes, n_ops)
        del q, sc, v, vt


def check_fused_precond_int8(torch, rows):
    """fused_precond on int8 R and L with their scales (the first product
    through matmul with an int8 operand) on the core its route picks -- the
    Hopper core (codes widened to bf16 in shared memory) at the bert-large
    shapes and at ragged ones whose rows are multiples of 16 codes, the
    WMMA core at (3, 1001, 600) -- and, at the bert-large shapes, on the
    WMMA core forced, rescale on and off; the bf16 route's bound
    2e-4·max|want| (the fp32 intermediate rides the tensor cores as a bf16
    hi/lo pair).  Timed at the bert-large shapes: both cores and the plain
    version; the Hopper core must be faster."""
    from repro_torch.kernels import precond as pc
    row = rows["fused_precond[int8]"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for b, di, do, main in [(96, 1024, 1024, True), (24, 1024, 4096, True),
                            (24, 4096, 1024, True), (2, 1008, 720, False),
                            (2, 720, 1008, False), (3, 1001, 600, False)]:
        rq, rsc = int8_bank(torch, b, di, gen)
        lq, lsc = int8_bank(torch, b, do, gen)
        g = (torch.randn((b, di, do), generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        kw = dict(r_scale=rsc, l_scale=lsc)
        route = pc.precond_route(rq.dtype, g.dtype, lq.dtype, di, do,
                                 rq.data_ptr(), g.data_ptr(), lq.data_ptr())
        require(route == ("wmma" if di % 16 or do % 16 else "wgmma"),
                f"fused_precond[int8] {b}x{di}x{do}: route {route}")
        for core in (None, "wmma") if main else (None,):
            for rescale in (True, False):
                got = expect_cores(
                    torch, lambda: pc.fused_precond(rq, g, lq,
                                                    rescale=rescale,
                                                    core=core, **kw),
                    {"fused_precond[int8]": 1, "matmul[int8 operand]": 1},
                    {core or route: 2}, f"fused_precond[int8] {b}x{di}x{do}")
                want = pc.fused_precond_plain(rq, g, lq, rescale=rescale,
                                              **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = 2e-4 * want.abs().max().item()
                print(f"fused_precond[int8] {b}x{di}x{do} rescale={rescale} "
                      f"[{core or route}]: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e})")
                require(math.isfinite(err) and err <= tol,
                        f"fused_precond[int8] {b}x{di}x{do} "
                        f"[{core or route}] disagrees with its plain version")
                require_repeatable(torch, lambda: pc.fused_precond(
                    rq, g, lq, rescale=rescale, core=core, **kw), got,
                    f"fused_precond[int8] {b}x{di}x{do} [{core or route}]")
                row.add(err)
                del got, want
        if main:
            ms = time_ms(torch, lambda: pc.fused_precond(rq, g, lq, **kw))
            old = time_ms(torch, lambda: pc.fused_precond(rq, g, lq,
                                                          core="wmma", **kw))
            plain = time_ms(torch, lambda: pc.fused_precond_plain(
                rq, g, lq, **kw))
            n_bytes = b * ((di * di + do * do) * 1 + di * do * 2
                           + di * do * 4 + 8)
            n_ops = b * 2.0 * di * do * (di + do)
            bms, by = row.bound(n_bytes, n_ops)
            print(f"fused_precond[int8] {b}x{di}x{do}: wgmma core {ms:.4f} ms "
                  f"{rate(n_ops, ms)}; wmma core {old:.4f} ms "
                  f"{rate(n_ops, old)}; plain {plain:.4f} ms; bound "
                  f"{bms:.4f} ms ({by})")
            require(ms < old, f"fused_precond[int8] {b}x{di}x{do}: the "
                    f"wgmma core ({ms:.4f} ms) is not faster than the wmma "
                    f"core ({old:.4f} ms)")
            row.add(0.0, ms, plain, n_bytes, n_ops)
            row.other_ms["wmma core"] += old
        del rq, lq, g


def check_matmul_int8(torch, rows):
    """matmul with an int8 operand (codes and (b,) scales) on the core its
    route picks -- the Hopper core at the first products fused_precond[int8]
    gives it at bert-large (G L⁻¹ with int8 L, R⁻¹ G with int8 R) and at
    ragged shapes of 16-code rows, the WMMA core for rows of 600 codes --
    and on the WMMA core forced at the bert-large shapes; the hi/lo pair of
    the scaled product wherever the Hopper core runs.  The plain version
    decodes first; the kernels scale the exact product of the codes, so
    fp32 rounding in another order: 1e-4·max|want| (the int8 bound of
    tests/test_torch_cuda.py).  Timed at the bert-large shapes: both cores
    and the plain version (no single PyTorch call takes an int8 operand
    beside a bf16 one: library_ms is null)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.ref import split_hi_lo
    row = rows["matmul[int8 operand]"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    for b, m, k, n, side, main in [(96, 1024, 1024, 1024, "b", True),
                                   (24, 1024, 4096, 4096, "b", True),
                                   (24, 4096, 4096, 1024, "a", True),
                                   (2, 1000, 1008, 720, "a", False),
                                   (3, 64, 96, 144, "b", False),
                                   (3, 1001, 600, 701, "a", False)]:
        if side == "a":
            a, sc = int8_bank(torch, b, m, gen) if m == k else (
                torch.randint(-127, 128, (b, m, k), generator=gen,
                              device="cuda").to(torch.int8),
                torch.full((b,), 1.0 / 127, device="cuda"))
            w = (torch.randn((b, k, n), generator=gen, device="cuda")
                 * 1e-2).to(torch.bfloat16)
            kw = dict(a_scale=sc)
        else:
            a = (torch.randn((b, m, k), generator=gen, device="cuda")
                 * 1e-2).to(torch.bfloat16)
            w, sc = int8_bank(torch, b, n, gen) if k == n else (
                torch.randint(-127, 128, (b, k, n), generator=gen,
                              device="cuda").to(torch.int8),
                torch.full((b,), 1.0 / 127, device="cuda"))
            kw = dict(b_scale=sc)
        route = mm.route_of(a, w)
        require(route == ("wmma" if (k if side == "a" else n) % 16
                          else "wgmma"),
                f"matmul[int8 operand] {b}x{m}x{k}x{n}: route {route}")
        want = mm.matmul_plain(a, w, **kw)
        tol = 1e-4 * want.abs().max().item()
        tag = f"matmul[int8 operand] {b}x{m}x{k}x{n} (int8 {side.upper()})"
        for core in (None, "wmma") if main else (None,):
            got = expect_cores(torch, lambda: mm.matmul(a, w, core=core,
                                                        **kw),
                               {"matmul[int8 operand]": 1}, {core or route: 1},
                               tag)
            err = (got - want).abs().max().item()
            print(f"{tag} [{core or route}]: max_abs_err {err:.3e} "
                  f"(tol {tol:.3e})")
            require(math.isfinite(err) and err <= tol,
                    f"{tag} [{core or route}] disagrees with its plain "
                    "version")
            row.add(err)
            del got
        if route == "wgmma":
            hi, lo = expect_cores(torch, lambda: mm.matmul_split(a, w, **kw),
                                  {"matmul[int8 operand]": 1}, {"wgmma": 1},
                                  f"{tag} hi/lo")
            err = (hi.float() + lo.float() - want).abs().max().item()
            bad = ((hi.float() - split_hi_lo(want)[0].float()).abs()
                   > 2.0 ** -7 * want.abs() + tol).sum().item()
            print(f"{tag} hi/lo: |hi + lo - want| max {err:.3e} (tol "
                  f"{tol:.3e}); {bad} of hi beyond one bf16 ulp of "
                  "bf16(want) (tol 0)")
            require(math.isfinite(err) and err <= tol and bad == 0,
                    f"{tag} hi/lo disagrees with split_hi_lo of the plain "
                    "product")
            row.add(err)
            del hi, lo
        if main:
            ms = time_ms(torch, lambda: mm.matmul(a, w, **kw))
            old = time_ms(torch, lambda: mm.matmul(a, w, core="wmma", **kw))
            plain = time_ms(torch, lambda: mm.matmul_plain(a, w, **kw))
            n_bytes = b * (m * k * a.element_size() + k * n * w.element_size()
                           + m * n * 4 + 4)
            n_ops = b * 2.0 * m * k * n
            bms, by = row.bound(n_bytes, n_ops)
            print(f"{tag}: wgmma core {ms:.4f} ms {rate(n_ops, ms)}; wmma "
                  f"core {old:.4f} ms {rate(n_ops, old)}; plain {plain:.4f} "
                  f"ms; bound {bms:.4f} ms ({by})")
            require(ms < old, f"{tag}: the wgmma core ({ms:.4f} ms) is not "
                    f"faster than the wmma core ({old:.4f} ms)")
            row.add(0.0, ms, plain, n_bytes, n_ops)
            row.other_ms["wmma core"] += old
        del a, w, want


# ----------------------------------------------------------------------- #
# Phase 4: full-width bert-large with mkor(lamb)
# ----------------------------------------------------------------------- #
def _max_rel(torch, xs, ys):
    num = sum(float(torch.sum(torch.square(x.float() - y.float())))
              for x, y in zip(xs, ys))
    den = sum(float(torch.sum(torch.square(y.float()))) for y in ys)
    return math.sqrt(num / max(den, 1e-30))


def bert_large_setup(dev, cfg=None):
    """Full-width bert-large with random weights from seed 0, its synthetic
    data (batch 8 x 128), and a maker of mkor(lamb) optimizers and their
    train steps."""
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib

    cfg = cfg or bert_large.CONFIG
    params = model_lib.init_params(cfg, seed=0, device=dev)
    print(f"{cfg.name}: {model_lib.param_count(params):,} params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"{cfg.dtype}")
    ds = pipeline.make_dataset(cfg, global_batch=8, seq_len=128, seed=0)

    def make(use_kernels, **kw):
        kw.setdefault("inv_freq", 3)
        mcfg = MKORConfig(use_kernels=use_kernels, **kw)
        opt = mkor(firstorder.lamb(1e-3), mcfg)
        return opt, train_lib.make_train_step(cfg, opt), mcfg
    return cfg, params, ds, make


def check_step0(torch, dev, cfg, params, ds, make):
    """Step 0 from the same state, through the kernels and the plain route.
    Without stagger every bucket inverts on step 0, so every bank side goes
    through fused_smw before it is compared."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_leaves

    opt_0k, step_0k, _ = make(True, stagger=False)
    opt_0p, step_0p, _ = make(False, stagger=False)
    batch0 = train_lib.batch_to_device(pipeline.make_batch(ds, 0), dev)
    pk, sk, mk = step_0k(params, opt_0k.init(params), batch0)
    pp, sp, mp = step_0p(params, opt_0p.init(params), batch0)
    compare_banks("step 0", sk["factor_banks"], sp["factor_banks"])
    p0 = tree_leaves(params)
    dk = [a.float() - b.float() for a, b in zip(tree_leaves(pk), p0)]
    dp = [a.float() - b.float() for a, b in zip(tree_leaves(pp), p0)]
    rel_upd = _max_rel(torch, dk, dp)
    # bf16 parameters: an update that lands on the other side of a bf16
    # rounding boundary moves by a whole ulp
    print(f"step 0 param update vs plain: relative Frobenius error "
          f"{rel_upd:.3e} (tol 2e-2)")
    require(rel_upd <= 2e-2, "step 0 parameter update differs")
    del dk, dp, sk, sp

    # the loss on batch 0 after the step: both routes must move it alike
    loss_fn = train_lib.make_loss_fn(cfg, collect_stats=False)
    with torch.no_grad():
        l0 = float(mk["loss"])
        lk = float(loss_fn(pk, batch0)[0])
        lp = float(loss_fn(pp, batch0)[0])
    # 5 % of what the step did to the loss, plus 1e-5 relative for bf16
    # parameters that round the other way
    tol = 0.05 * abs(lp - l0) + 1e-5 * abs(lp)
    print(f"step 0 loss {l0:.6f}; after the step: kernels {lk:.6f}, plain "
          f"{lp:.6f} (|diff| {abs(lk - lp):.3e}, tol {tol:.3e})")
    require(math.isfinite(lk) and abs(lk - lp) <= tol,
            "loss after step 0 differs")
    del pk, pp


def compare_banks(tag, got, want, bucket_ids=None):
    """Every bank side of ``bucket_ids`` (default all), kernel route
    against plain route, with the elementwise bf16 bound."""
    for bid in (bucket_ids if bucket_ids is not None else sorted(got)):
        for side in ("l_inv", "r_inv"):
            err, ratio = bf16_close(got[bid][side], want[bid][side])
            print(f"{tag} bank {bid}/{side}: max_abs_err {err:.3e}, worst "
                  f"|got-want| / (2^-7|want| + 1e-5 max|want|) {ratio:.3f} "
                  "(tol 1)")
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{tag} bank {bid}/{side} differs")


def block_update_f64(j, vt, gm, *, variant="paper", with_pivot=False,
                     scale=None):
    """``fused_block_smw_plain``'s update evaluated in float64 over the
    whole bank and rounded once to j's dtype (fp32 for int8 codes with
    ``scale``): the plain route's block update on the int8 paths, whose
    bank check holds the kernel route to an fp32 bound.  A window of nearly
    collinear rows makes the mid matrix ill-conditioned, and then U summed
    over d terms in fp32 carries an error, times that condition, beyond the
    bound (``scripts/smw_f64_probe.py`` holds the kernel and the fp32 plain
    version against this)."""
    import torch
    jf = j.double() if scale is None else \
        j.double() * scale.double()[..., None, None]
    vf = vt.double()
    g = torch.as_tensor(gm, dtype=torch.float64,
                        device=jf.device)[..., None, None]
    u = torch.matmul(vf, jf.transpose(-1, -2))          # rows (J ṽ_i)ᵀ
    s = torch.matmul(vf, u.transpose(-1, -2))           # ṼJṼᵀ (r, r)
    eye = torch.eye(vf.shape[-2], dtype=torch.float64, device=jf.device)
    if variant == "paper":
        mid = g * g * eye + g * g * g * s
        new = g * jf + torch.matmul(u.transpose(-1, -2),
                                    torch.linalg.solve(mid, u))
    else:
        mid = g * eye + s
        new = (jf - torch.matmul(u.transpose(-1, -2),
                                 torch.linalg.solve(mid, u))) / g
    new = new.float() if scale is not None else new.to(j.dtype)
    if not with_pivot:
        return new
    chol, info = torch.linalg.cholesky_ex(mid)
    piv = torch.amin(torch.diagonal(chol, dim1=-2, dim2=-1) ** 2,
                     dim=-1).float()
    return new, torch.where(info == 0, piv, torch.full_like(piv, math.nan))


class Int8BankCheck:
    """Holds int8 bank sides of the kernel route against the plain route's
    (its block update in float64, :func:`block_update_f64`): the
    reconstructed fp32 bank decode(codes, scale) + error feedback with
    the fp32 elementwise bound 1e-5|want| + 1e-6 max|want| (it equals the
    stabilized fp32 update plus the old error feedback exactly, and the
    kernel's update differs from the exact one by fp32 rounding only), and
    the codes at most one step apart (a rounding difference can move a
    value across a code boundary; the error feedback carries the other
    side).  Records the worst ratio and the share of codes that differ."""

    def __init__(self, torch):
        self.torch = torch
        self.worst, self.flipped, self.codes = 0.0, 0, 0

    def __call__(self, tag, got, want, bucket_ids=None):
        torch = self.torch
        for bid in (bucket_ids if bucket_ids is not None else sorted(got)):
            for side in ("l", "r"):
                q_k, s_k, e_k = (f"{side}_inv", f"{side}_scale",
                                 f"{side}_ef")
                g, w = got[bid], want[bid]
                rec_g = g[q_k].float() * g[s_k][..., None, None] + g[e_k]
                rec_w = w[q_k].float() * w[s_k][..., None, None] + w[e_k]
                err, ratio = bf16_close(rec_g, rec_w, 1e-5, 1e-6)
                del rec_g, rec_w
                dq = (g[q_k].to(torch.int16) - w[q_k].to(torch.int16)).abs()
                max_dq, n_flip = int(dq.max()), int((dq > 0).sum())
                self.worst = max(self.worst, ratio)
                self.flipped += n_flip
                self.codes += dq.numel()
                print(f"{tag} bank {bid}/{side}: decode + ef max_abs_err "
                      f"{err:.3e}, worst |got-want| / (1e-5|want| + 1e-6 "
                      f"max|want|) {ratio:.3f} (tol 1); codes: max diff "
                      f"{max_dq} (tol 1), {n_flip} of {dq.numel()} differ")
                require(math.isfinite(ratio) and ratio <= 1.0,
                        f"{tag} bank {bid}/{side}: decode + ef differs")
                require(max_dq <= 1, f"{tag} bank {bid}/{side}: codes "
                        "differ by more than one step")

    def summary(self, name):
        share = self.flipped / max(self.codes, 1)
        print(f"[{name}] kernel vs plain route (block update in float64): "
              f"worst decode+ef ratio "
              f"{self.worst:.3f} (tol 1), {self.flipped} of {self.codes} "
              f"codes differ by one step ({share:.3e})")


class PlainTee:
    """An optimizer that runs the kernel route and, at the listed counts,
    also the plain route on the same inputs, and holds the banks of the
    buckets that invert against each other (``compare``, default the
    elementwise bf16 bound of :func:`compare_banks`).  ``block``, when
    given, stands in for the plain route's block update
    (``core.mkor.fused_block_smw_plain``) while it runs.  The plain route
    launches no kernel, so the launch counts stay those of the main path;
    ``in_plain`` is True while it runs.  ``events`` records the call order
    of precompute and update.  ``keys`` name the state's active and pending
    factors: the banks, or the per-layer layout's ``factors`` and
    ``pending_factors`` (``phases`` then keyed by layer)."""

    def __init__(self, torch, opt_k, opt_p, phases, inv_freq,
                 update_at=(), tick_at=(), compare=None, block=None,
                 keys=("factor_banks", "pending_banks")):
        self.torch, self.opt_k, self.opt_p = torch, opt_k, opt_p
        self.phases, self.inv_freq = phases, inv_freq
        self.update_at, self.tick_at = set(update_at), set(tick_at)
        self.compare = compare or compare_banks
        self.block = block
        self.keys = keys
        self.events, self.compared = [], []
        self.in_plain = False

    def plain(self, fn, *args, **kw):
        from repro_torch.core import mkor as mkor_lib
        kept = mkor_lib.fused_block_smw_plain
        if self.block is not None:
            mkor_lib.fused_block_smw_plain = self.block
        self.in_plain = True
        try:
            return fn(*args, **kw)
        finally:
            self.in_plain = False
            mkor_lib.fused_block_smw_plain = kept

    def due(self, count):
        return [b for b, ph in sorted(self.phases.items())
                if count % self.inv_freq == ph]

    def transformation(self):
        from repro_torch.core.firstorder import GradientTransformation
        return GradientTransformation(
            self.opt_k.init, self.update,
            self.precompute if self.opt_k.precompute is not None else None)

    def precompute(self, state, params=None, **kw):
        self.events.append("precompute")
        new = self.opt_k.precompute(state, params=params, **kw)
        count = int(state["count"])
        if count in self.tick_at:
            plain = self.plain(self.opt_p.precompute, state, params=params,
                               **kw)
            self.torch.cuda.synchronize()
            self.compare(f"tick {count} pending", new[self.keys[1]],
                         plain[self.keys[1]], self.due(count))
            self.compared.append(count)
        return new

    def update(self, grads, state, params=None, stats=None, **kw):
        self.events.append("update")
        out = self.opt_k.update(grads, state, params=params, stats=stats,
                                **kw)
        count = int(state["count"])
        if count in self.update_at:
            plain = self.plain(self.opt_p.update, grads, state,
                               params=params, stats=stats, **kw)
            self.torch.cuda.synchronize()
            self.compare(f"step {count}", out[1][self.keys[0]],
                         plain[1][self.keys[0]], self.due(count))
            self.compared.append(count)
        return out


def run_path(torch, dev, name, step_fn, opt, params, ds, steps,
             skip_times=(), on_step=None, fallbacks_per_step=None):
    """One counted training path: launch counts and fallbacks set to 0
    just before it, read just after; fresh optimizer state.  The steps in
    ``skip_times`` hold the kernel route against the plain route, so the
    peak memory is also read over the steps after the last of them
    alone.  ``on_step(step, state, ms)`` runs after each timed step.
    Returns (params, state, counts)."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    state = opt.init(params)
    losses, times = [], []
    last = max(skip_times, default=None)
    peak_to_last = 0
    for step in range(steps):
        batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, state, times[-1])
        if step == last:
            peak_to_last = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats()
    counts = ops.launch_counts()
    cores = ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    peak_after = torch.cuda.max_memory_allocated(dev)
    peak = max(peak_to_last, peak_after) / 2 ** 30
    if last is None:
        after = "no step compared on the path"
    elif last == steps - 1:
        after = f"no step after the last compared step {last}"
    else:
        span = f"step {last + 1}" if last + 2 == steps else \
            f"steps {last + 1}-{steps - 1}"
        after = (f"{span}, after the last compared step: "
                 f"{peak_after / 2 ** 30:.3f} GiB")
    print(f"[{name}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss")
    clean = [t for i, t in enumerate(times) if i > 0 and i not in skip_times]
    print(f"[{name}] step ms {[round(t, 3) for t in times]} (median of "
          f"steps {[i for i in range(1, steps) if i not in skip_times]} "
          f"{statistics.median(clean):.3f} ms), peak memory {peak:.3f} GiB "
          f"({after})")
    SUMMARY[name]["eager_ms"] = statistics.median(clean)
    SUMMARY[name]["eager_peak"] = (peak if last is None or last == steps - 1
                                   else peak_after / 2 ** 30)
    require_path_kernels(name, counts, cores, fallbacks,
                         None if fallbacks_per_step is None else
                         {k: v * steps for k, v in
                          fallbacks_per_step.items()})
    return params, state, counts


def require_fallbacks(name, fallbacks, expected=None):
    """A path's fallbacks: none, or on a zoo path only those of
    ALLOWED_FALLBACKS, at ``expected`` counts when given."""
    allowed = ALLOWED_FALLBACKS.get(name, ())
    require(all(k in allowed for k in fallbacks),
            f"{name}: fallbacks on the path: {fallbacks}")
    if expected is not None:
        require(fallbacks == {k: v for k, v in expected.items() if v},
                f"{name}: fallbacks {fallbacks}, expected {expected}")


def require_path_kernels(name, counts, cores, fallbacks, expected=None):
    """Print a path's launch and core counts and hold them to
    PATH_KERNELS, with no fallback (a zoo path: the expected ones) and
    every GEMM on the Hopper core (but on a zoo path)."""
    print(f"[{name}] launch counts {counts}, GEMM cores {cores}, fallbacks "
          f"{fallbacks}")
    must, must_not = PATH_KERNELS[name]
    for k in must:
        require(counts.get(k, 0) > 0,
                f"{name}: {k} was not launched on the training path")
    for k in must_not:
        require(counts.get(k, 0) == 0,
                f"{name}: {k} was launched on the training path")
    require_fallbacks(name, fallbacks, expected)
    if name in WGMMA_PATHS:
        # every GEMM of matmul and fused_precond (two a launch: its first
        # product runs through matmul) on the Hopper core
        gemms = sum(counts.get(k, 0) for k in GEMM_KERNELS)
        require(cores.get("wmma", 0) == 0 and
                cores.get("wgmma", 0) == gemms,
                f"{name}: GEMM cores {cores}, expected all {gemms} on wgmma")


def profile_and_phases(torch, dev, cfg, ds, step_fn, opt, params, state,
                       step, name):
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
    SUMMARY[name]["eager_busy"] = profile_step(
        torch, lambda: step_fn(params, state, batch))
    phase_breakdown(torch, cfg, opt, params, state, batch,
                    torch.cuda.synchronize)


def train_rank1(torch, dev, setup):
    """Path a: PR 12's rank-1 main path, unchanged."""
    cfg, params, ds, make = setup
    check_step0(torch, dev, cfg, params, ds, make)
    opt_k, step_k, _ = make(True)
    params, state, counts = run_path(torch, dev, "rank1", step_k, opt_k,
                                     params, ds, TRAIN_STEPS)
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params, state,
                       TRAIN_STEPS, "rank1")
    return counts, (step_k, params, state)


def _phases(params, mcfg):
    from repro_torch.core import stats as statlib
    from repro_torch.core.mkor import manifest_for
    return statlib.bucket_phases(manifest_for(params, mcfg), mcfg.inv_freq,
                                 mcfg.stagger)


def train_rank4(torch, dev, setup):
    """Path b: block rank 4, inv_freq 4, stagger.  Bucket i consumes at
    counts i and i + 4: first a partial window (i + 1 rows), then a full
    one, which is held against the plain route."""
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    opt_k, _, mcfg = make(True, rank=4, inv_freq=4)
    opt_p, _, _ = make(False, rank=4, inv_freq=4)
    phases = _phases(params, mcfg)
    first_full = [ph + mcfg.inv_freq for ph in sorted(set(phases.values()))]
    tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq,
                   update_at=first_full)
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    params, state, counts = run_path(torch, dev, "rank4", step_fn, opt,
                                     params, ds, RANK4_STEPS,
                                     skip_times=first_full)
    require(tee.compared == first_full,
            f"rank4: compared at {tee.compared}, expected {first_full}")
    # one more step (bucket 0 consumes its second full window), profiled
    step_k = train_lib.make_train_step(cfg, opt_k)
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params, state,
                       RANK4_STEPS, "rank4")
    return counts, (step_k, params, state)


def train_staleness1(torch, dev, setup):
    """Path c: staleness 1 at rank 1, inv_freq 3, stagger.  Bucket i ticks
    at counts i, i + 3, i + 6: its first launch consumes an empty window,
    its second one row; the promoted active bank leaves the identity at
    the third tick."""
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    opt_k, _, mcfg = make(True, staleness=1)
    opt_p, _, _ = make(False, staleness=1)
    phases = _phases(params, mcfg)
    # the first tick that launches, then each bucket's first tick with a
    # non-empty window
    ticks = [0] + [ph + mcfg.inv_freq for ph in sorted(set(phases.values()))]
    tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq, tick_at=ticks)
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    forward = model_lib.forward

    def traced_forward(*args, **kwargs):
        tee.events.append("forward")
        return forward(*args, **kwargs)

    model_lib.forward = traced_forward
    try:
        params, state, counts = run_path(torch, dev, "staleness1", step_fn,
                                         opt, params, ds, STALE_STEPS,
                                         skip_times=ticks)
    finally:
        model_lib.forward = forward
    require(tee.events == ["precompute", "forward", "update"] * STALE_STEPS,
            f"staleness1: call order {tee.events[:6]}...")
    print(f"[staleness1] every step ran precompute, then the forward, then "
          f"update ({STALE_STEPS} steps); compared ticks {tee.compared}")
    require(tee.compared == ticks, f"staleness1: compared at {tee.compared}")
    for bid, bank in sorted(state["factor_banks"].items()):
        d = bank["l_inv"].shape[-1]
        eye = torch.eye(d, dtype=bank["l_inv"].dtype, device=dev)
        moved = (bank["l_inv"] - eye).abs().max().item()
        print(f"[staleness1] active bank {bid}/l_inv: max |F - I| "
              f"{moved:.3e} after {STALE_STEPS} steps")
        require(moved > 0, f"staleness1: active bank {bid} is still the "
                "identity")
    # one more step (a tick that launches for the 1024x1024 bucket),
    # profiled; the phase times run the tick inline inside the update
    step_k = train_lib.make_train_step(cfg, opt_k)
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params, state,
                       STALE_STEPS, "staleness1")
    return counts, (step_k, params, state)


def _int8_path(torch, dev, setup, name, steps, **kw):
    """One int8 training path (factor_quant="int8"): the kernel route,
    teed to the plain route (its block update in float64) at each
    bucket's first inversion (staleness 1:
    the first tick that launches, and each bucket's first tick with a
    non-empty window); counts the bank decodes the kernel route makes
    (window rows are decoded; banks must not be)."""
    from repro_torch.core import stats as statlib
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    opt_k, _, mcfg = make(True, factor_quant="int8", **kw)
    opt_p, _, _ = make(False, factor_quant="int8", **kw)
    phases = _phases(params, mcfg)
    firsts = sorted(set(phases.values()))
    check = Int8BankCheck(torch)
    if mcfg.staleness:
        at = [0] + [ph + mcfg.inv_freq for ph in firsts]
        tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq,
                       tick_at=at, compare=check, block=block_update_f64)
    else:
        at = firsts
        tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq,
                       update_at=at, compare=check, block=block_update_f64)
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    decode, forward = statlib.quant_decode, model_lib.forward
    kernel_decodes = []

    def counted_decode(q, scale, axes=2):
        if not tee.in_plain:
            kernel_decodes.append(tuple(q.shape))
        return decode(q, scale, axes)

    def traced_forward(*args, **kwargs):
        tee.events.append("forward")
        return forward(*args, **kwargs)

    statlib.quant_decode, model_lib.forward = counted_decode, traced_forward
    try:
        params, state, counts = run_path(torch, dev, name, step_fn, opt,
                                         params, ds, steps, skip_times=at)
    finally:
        statlib.quant_decode, model_lib.forward = decode, forward
    require(tee.compared == at, f"{name}: compared at {tee.compared}, "
            f"expected {at}")
    check.summary(name)
    print(f"[{name}] bank decodes on the kernel route: "
          f"{len(kernel_decodes)}")
    require(not kernel_decodes, f"{name}: the kernel route decoded banks "
            f"{kernel_decodes[:4]}")
    order = ["precompute", "forward", "update"] if mcfg.staleness else \
        ["forward", "update"]
    require(tee.events == order * steps,
            f"{name}: call order {tee.events[:6]}...")
    for bid, bank in sorted(state["factor_banks"].items()):
        # the factor is decode + ef: off-diagonal terms below half a code
        # step live in the error feedback alone
        d = bank["l_inv"].shape[-1]
        eye = 127 * torch.eye(d, dtype=torch.int8, device=dev)
        codes = int((bank["l_inv"].to(torch.int16) - eye).abs().max())
        rec = bank["l_inv"].float() * bank["l_scale"][..., None, None] \
            + bank["l_ef"]
        moved = (rec - torch.eye(d, device=dev)).abs().max().item()
        print(f"[{name}] active bank {bid}/l_inv: max |decode + ef - I| "
              f"{moved:.3e}, max |codes - 127 I| {codes}, scale "
              f"{bank['l_scale'].min().item():.4g}.."
              f"{bank['l_scale'].max().item():.4g}, max |ef| "
              f"{bank['l_ef'].abs().max().item():.3e} after {steps} steps")
        del rec
        require(moved > 0, f"{name}: active bank {bid} is still the "
                "identity")
    step_k = train_lib.make_train_step(cfg, opt_k)
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params, state,
                       steps, name)
    return counts, (step_k, params, state)


def train_int8_rank1(torch, dev, setup):
    """Path d: int8 factor state at rank 1, inv_freq 3, stagger."""
    return _int8_path(torch, dev, setup, "int8_rank1", TRAIN_STEPS)


def train_int8_rank4(torch, dev, setup):
    """Path e: int8 factor state, block rank 4, inv_freq 4, stagger."""
    return _int8_path(torch, dev, setup, "int8_rank4", RANK4_STEPS, rank=4,
                      inv_freq=4)


def train_int8_staleness1(torch, dev, setup):
    """Path f: int8 factor state at staleness 1, rank 1, inv_freq 3."""
    return _int8_path(torch, dev, setup, "int8_staleness1", STALE_STEPS,
                      staleness=1)


def train_lamb(torch, dev, setup):
    """Path g: LAMB alone, no MKOR (the step MKOR's overhead is measured
    against), LAMB_STEPS steps; a profiled step."""
    from repro_torch.core import firstorder
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    cfg, params, ds, _ = setup
    opt = firstorder.lamb(1e-3)
    step = train_lib.make_train_step(cfg, opt)
    params, state, counts = run_path(torch, dev, "lamb", step, opt, params,
                                     ds, LAMB_STEPS)
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, LAMB_STEPS),
                                      dev)
    SUMMARY["lamb"]["eager_busy"] = profile_step(
        torch, lambda: step(params, state, batch))
    return counts, (step, params, state)


# ----------------------------------------------------------------------- #
# Phase 5: the same paths captured as CUDA graphs (training/loop.py)
# ----------------------------------------------------------------------- #
# LAMB's moment decays (firstorder.lamb's defaults, as the paths use them)
LAMB_B1, LAMB_B2 = 0.9, 0.999


def flat_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def may_differ(path):
    """The parameters, LAMB's moments and the update norm: the leaves that
    fused_precond's rescale reaches."""
    return path[0] == "params" or path == ("metrics", "update_norm") or \
        path[:3] in (("state", "backend", "m"), ("state", "backend", "v"))


def replay_tol(path, want, old):
    """The bound on a leaf of :func:`may_differ` (PERF.md states it);
    ``old`` is the leaf before the step.  fused_precond sums ΣΔ² with
    atomics in another order on every launch (csrc/precond.cu), so its
    rescale factor may move by an fp32 ulp and an element of its bf16
    output g' by one bf16 ulp (at most 2^-7 |g'|).  LAMB's m = b1·m_old +
    (1 - b1)·g' then moves by at most 2^-7 |m - b1·m_old|, and v =
    b2·v_old + (1 - b2)·g'² by (2^-6 + 2^-14) |v - b2·v_old|; the update
    u = -lr·trust·m̂/(√v̂ + eps) (+ decay) by 2^-6 |u| in fp32 and one more
    bf16 ulp when cast, under 2^-5 |u|, so a bf16 parameter p = p_old + u
    moves by 2^-5 |p - p_old| and one ulp of its own, and the update norm
    by 2^-5 of itself.  Each adds two fp32 ulps of the leaf (2^-22 |want|)
    and 1e-6 max|want|."""
    w = want.float()
    if path[:3] == ("state", "backend", "m"):
        step = 2.0 ** -7 * (w - LAMB_B1 * old.float()).abs()
    elif path[:3] == ("state", "backend", "v"):
        step = (2.0 ** -6 + 2.0 ** -14) * (w - LAMB_B2 * old.float()).abs()
    elif path[0] == "params":
        step = 2.0 ** -6 * w.abs() + 2.0 ** -5 * (w - old.float()).abs()
    else:
        step = 2.0 ** -5 * w.abs()
    return step + 2.0 ** -22 * w.abs() + 1e-6 * w.abs().max()


class ReplayCheck:
    """Stands in for a chunk runner's replay: before each replay the eager
    step runs from copies of the same state (its launches set aside, like
    the plain route's), and the replay's params, whole optimizer state
    (banks, windows, LAMB moments, counts) and metrics must be
    ``torch.equal`` to it; on a kernel path the leaves of
    :func:`may_differ` are held to REPLAY_REL instead.  The first time, the
    eager step also runs twice from the same state, to show whether its
    own results repeat.  Records the launches credited to the replays."""

    def __init__(self, torch, runner, step_fn, name, bounded):
        self.torch, self.runner, self.step_fn = torch, runner, step_fn
        self.name, self.bounded = name, bounded
        self.replay, runner._replay = runner._replay, self
        self.n = self.leaves = self.differ = 0
        self.worst = {}                    # leaf path -> worst ratio
        self.replay_counts = collections.Counter()
        self.per_replay = []               # (count, launches) per replay
        self.eager_repeat = None
        self.on_replay = None              # (count, params, state) hook

    def eager(self, p, s, b):
        """The eager step from copies of the state (the step is functional:
        they stay as they were), its launches set aside."""
        from repro_torch.kernels import build
        mark = build.count_mark()
        out = self.step_fn(p, s, b)
        build.rewind_counts(mark)
        return {"params": out[0], "state": out[1],
                "metrics": {k: out[2][k].float() for k in self.runner._keys}}

    def __call__(self, graph):
        from repro_torch.tree import tree_map
        torch, r = self.torch, self.runner
        p, s, b = tree_map(torch.clone, (*r._tree_at(r.host), r._batch))
        self.old = {"params": p, "state": s}
        want = self.eager(p, s, b)
        if self.eager_repeat is None:
            again = dict(flat_paths(self.eager(p, s, b)))
            self.eager_repeat = [
                "/".join(map(str, k)) for k, v in flat_paths(want)
                if not torch.equal(v, again[k])]
            del again
        self.replay(graph)
        self.replay_counts.update(graph.counts[0])
        self.per_replay.append((int(s["count"]), dict(graph.counts[0])))
        params, state = r._tree_at([h + d for h, d in
                                    zip(r.host, graph.delta)])
        got = dict(flat_paths({"params": params, "state": state,
                               "metrics": dict(zip(r._keys, r._metrics))}))
        want = dict(flat_paths(want))
        require(sorted(got, key=str) == sorted(want, key=str),
                f"{self.name}: the replay's tree is not the eager step's")
        for path, w in want.items():
            g, tag = got[path], "/".join(map(str, path))
            self.leaves += 1
            require(g.dtype == w.dtype and g.shape == w.shape,
                    f"{self.name}: {tag} has another dtype or shape")
            if torch.equal(g, w):
                continue
            self.differ += 1
            require(self.bounded and may_differ(path),
                    f"{self.name}: replay and eager step differ at {tag}, "
                    "which must be bit for bit")
            old = self.old if path[0] != "metrics" else None
            for k in path if old is not None else ():
                old = old[k]
            tol = replay_tol(path, w, old)
            ratio = float(((g.float() - w.float()).abs() / tol).max())
            self.worst[tag] = max(self.worst.get(tag, 0.0), ratio)
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{self.name}: {tag} differs from the eager step by "
                    f"{ratio:.3f} of its bound")
        self.n += 1
        del self.old
        if self.on_replay is not None:
            self.on_replay(int(s["count"]), params, state)

    def report(self):
        worst = sorted(self.worst.items(), key=lambda kv: -kv[1])
        kinds = collections.defaultdict(float)
        for tag, ratio in worst:
            kind = tag.split("/")[0] if not tag.startswith("state") else \
                "LAMB " + tag.split("/")[2]
            kinds[kind] = max(kinds[kind], ratio)
        print(f"[{self.name}] {self.n} replays, each against the eager step "
              f"from the same state: {self.leaves - self.differ} of "
              f"{self.leaves} leaf comparisons bit for bit (losses, grad "
              f"norms, banks, windows and counts always); "
              f"{len(self.worst)} leaves differ somewhere, worst ratio to "
              f"the bound by kind {dict(kinds) or 'none'} (tol 1)")
        for tag, ratio in worst[:8]:
            print(f"  {tag}: worst |replay - eager| / bound {ratio:.3f}")
        if len(worst) > 8:
            print(f"  ... {len(worst) - 8} more leaves, each at most "
                  f"{worst[8][1]:.3f}")
        print(f"[{self.name}] the eager step twice from the same state: "
              f"{len(self.eager_repeat)} leaves differ"
              + (f" ({', '.join(self.eager_repeat[:4])}"
                 + (", ..." if len(self.eager_repeat) > 4 else "") + ")"
                 if self.eager_repeat else ""))


def _one_step(ds, i):
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    return train_lib.stack_batches([pipeline.make_batch(ds, i)])


def graph_path(torch, dev, name, step_fn, params, state, ds, start, n_keys):
    """The captured version of path ``name`` from its eager run's final
    state (count ``start``), through the chunk runner in chunks of
    ``n_keys`` (the residues of inv_freq): 3 x n_keys steps, so every
    residue's first step runs eagerly before its capture and its graph
    then replays twice, each replay held against the eager step
    (:class:`ReplayCheck`).  Launch counts set to 0 just before, read just
    after: warm-up steps plus the replays' credited counts, which alone
    must also launch every kernel of PATH_KERNELS.  Then replays alone
    (each a one-step chunk with its metrics fetch): step times, peak
    memory allocated and reserved (the static buffers, the graph pool),
    and a profiled replay.  Returns (counts, params, state, runner)."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib
    gname = f"{name}[graph]"
    steps = 3 * n_keys
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    runner = train_lib.make_chunk_runner(step_fn)
    check = ReplayCheck(torch, runner, step_fn, gname, name != "lamb")
    batches = [pipeline.make_batch(ds, start + i) for i in range(steps)]
    params, state, hist = train_lib.train_epoch(
        step_fn, params, state, batches, chunk=n_keys, runner=runner)
    counts = ops.launch_counts()
    cores = ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    losses = [h["loss"] for h in hist]
    print(f"[{gname}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses),
            f"{gname}: non-finite loss")
    require(len(runner.graphs) == n_keys and check.n == steps - n_keys,
            f"{gname}: {len(runner.graphs)} graphs, {check.n} replays")
    require(int(state["count"]) == start + steps,
            f"{gname}: count {int(state['count'])}")
    check.report()
    print(f"[{gname}] {len(runner.graphs)} graphs, keys "
          f"{sorted(map(str, runner.graphs))}; launch counts {counts} "
          f"(replays alone {dict(check.replay_counts)}), GEMM cores {cores},"
          f" fallbacks {fallbacks}")
    must, must_not = PATH_KERNELS[name]
    for k in must:
        require(counts.get(k, 0) > 0 and check.replay_counts.get(k, 0) > 0,
                f"{gname}: {k} was not launched under replay")
    for k in must_not:
        require(counts.get(k, 0) == 0, f"{gname}: {k} was launched")
    require_fallbacks(name, fallbacks)
    if name in WGMMA_PATHS:
        gemms = sum(counts.get(k, 0) for k in GEMM_KERNELS)
        require(cores.get("wmma", 0) == 0 and
                cores.get("wgmma", 0) == gemms,
                f"{gname}: GEMM cores {cores}, expected all {gemms} on "
                "wgmma")
    del runner._replay, check              # the runner's own replay again
    gc.collect()                           # the checks' copies go
    params, state = replays_alone(torch, dev, name, runner, params, state,
                                  ds, start + steps, n_keys)
    return counts, params, state, runner


def replays_alone(torch, dev, name, runner, params, state, ds, start,
                  n_keys):
    """2 x ``n_keys`` replays alone from count ``start`` (each a one-step
    chunk with its metrics fetch): step times, peak memory allocated and
    reserved (the static buffers, the graph pool), then a profiled
    replay, into SUMMARY[name].  Returns (params, state)."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, i = [], start
    for _ in range(2 * n_keys):
        batch = _one_step(ds, i)
        t0 = time.perf_counter()
        params, state, _ = runner(params, state, batch)   # fetch: a sync
        times.append((time.perf_counter() - t0) * 1e3)
        i += 1
    alloc = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    reserved = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    median = statistics.median(times)
    print(f"[{name}[graph]] replays alone, steps {start}-{i - 1}: step ms "
          f"{[round(t, 3) for t in times]} (median {median:.3f} ms), peak "
          f"memory {alloc:.3f} GiB allocated, {reserved:.3f} GiB reserved "
          "(static buffers and the graph pool)")
    out = {}
    batch = _one_step(ds, i)

    def one():
        out["step"] = runner(params, state, batch)
    busy = profile_step(torch, one)
    params, state, _ = out.pop("step")
    SUMMARY[name].update(graph_ms=median, graph_busy=busy,
                         graph_alloc=alloc, graph_reserved=reserved,
                         graphs=len(runner.graphs))
    return params, state


def turns(torch, dev, name, step_fn, runner, params, state, ds, start):
    """Eager and captured steps in turns, in one process: eager, captured,
    captured, eager, TURN_STEPS steps each (each step synchronized; the
    captured one is a one-step chunk with its metrics fetch); each turn's
    median drops its first step.  Then one chunk of 8 replays with one
    metrics fetch."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    i, medians = start, {"eager": [], "captured": []}
    for kind in ("eager", "captured", "captured", "eager"):
        times = []
        for _ in range(TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "eager":
                batch = train_lib.batch_to_device(
                    pipeline.make_batch(ds, i), dev)
                params, state, _ = step_fn(params, state, batch)
                torch.cuda.synchronize()
            else:
                params, state, _ = runner(params, state, _one_step(ds, i))
            times.append((time.perf_counter() - t0) * 1e3)
            i += 1
        med = statistics.median(times[1:])
        medians[kind].append(med)
        print(f"[{name} turns] {kind}: step ms "
              f"{[round(t, 3) for t in times]}, median of steps 2-"
              f"{TURN_STEPS} {med:.3f}")
    # the chunk starts from the eager turn's tensors: bring them into the
    # static buffers first, outside the timed chunk
    params, state, _ = runner(params, state, _one_step(ds, i))
    i += 1
    stacked = train_lib.stack_batches([pipeline.make_batch(ds, i + k)
                                       for k in range(8)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, metrics = runner(params, state, stacked)
    chunk_ms = (time.perf_counter() - t0) * 1e3 / 8
    require(all(math.isfinite(float(x)) for x in metrics["loss"]),
            f"{name} turns: non-finite loss")
    eager = statistics.median(medians["eager"])
    captured = statistics.median(medians["captured"])
    print(f"[{name} turns] median over both turns: eager {eager:.3f} ms, "
          f"captured {captured:.3f} ms; a chunk of 8 replays with one "
          f"metrics fetch: {chunk_ms:.3f} ms a step")
    SUMMARY[name].update(turn_eager=eager, turn_captured=captured,
                         chunk8=chunk_ms)


def summary_lines():
    def busy(b):
        if b is None or b[1] is None:
            return "not measured"
        return f"{b[1]:.3f} of {b[0]:.3f} ms ({100 * b[1] / b[0]:.1f} %)"
    for name, v in SUMMARY.items():
        if name.startswith("zoo "):
            print(f"summary [{name}]: losses {v['losses']} (step 0, step "
                  f"1), peak memory {v['peak']:.3f} GiB, fallbacks "
                  f"{v['fallbacks']}, {v['seconds']:.1f} s")
            continue
        if name == "elastic_p1":
            e, p = v["turn_elastic"], v["turn_plain"]
            (_, pa, pr), (eb, ea, er) = v["mem"]["plain"], v["mem"]["elastic"]
            r1, freed, r2 = v["rebuild"]
            print(f"summary [{name}]: captured step in turns with --elastic "
                  f"{e:.3f} ms against {p:.3f} ms without ({e - p:+.3f} ms, "
                  f"{100 * (e - p) / p:+.1f} %); peak memory without "
                  f"{pa:.3f} GiB allocated ({pr:.3f} reserved), with "
                  f"{ea:.3f} GiB ({er:.3f} reserved; {eb:.3f} GiB allocated "
                  f"before it); rebuild: peak reserved {r1:.3f} GiB with the "
                  f"first runner, {freed:.3f} GiB after its release, "
                  f"{r2:.3f} GiB after the second capture; launcher runs "
                  f"{', '.join(f'{x:.1f}' for x in v['launch_s'])} s, the "
                  f"emergency checkpoint at cursor {v['cursor']}")
            continue
        if "graph_ms" not in v:             # paths l and n run eagerly
            print(f"summary [{name}]: step median eager "
                  f"{v['eager_ms']:.3f} ms (not captured); peak memory "
                  f"eager {v['eager_peak']:.3f} GiB")
            continue
        line = (f"summary [{name}]: step median eager "
                f"{v['eager_ms']:.3f} ms, captured {v['graph_ms']:.3f} ms; "
                f"device busy in a profiled step eager "
                f"{busy(v.get('eager_busy'))}, captured "
                f"{busy(v.get('graph_busy'))}; peak memory eager "
                f"{v['eager_peak']:.3f} GiB, captured "
                f"{v['graph_alloc']:.3f} GiB allocated "
                f"({v['graph_reserved']:.3f} reserved), {v['graphs']} graphs")
        if "turn_eager" in v:
            line += (f"; in turns eager {v['turn_eager']:.3f} ms, captured "
                     f"{v['turn_captured']:.3f} ms, a chunk of 8 "
                     f"{v['chunk8']:.3f} ms a step")
        if "graph_pre_ms" in v:
            n_bytes, t_save, t_restore = v["ckpt"]
            line += (f"; before the flip eager {v['eager_pre_ms']:.3f} ms, "
                     f"captured {v['graph_pre_ms']:.3f} ms (the medians "
                     f"above: after it); in turns captured after the flip "
                     f"{v['turn_post']:.3f} ms against LAMB alone "
                     f"{v['turn_lamb']:.3f} ms; checkpoint {n_bytes:,} "
                     f"bytes, save {t_save:.3f} s, restore {t_restore:.3f} s")
        if "turn_dist" in v:
            d, sd = v["turn_dist"], v["turn_single"]
            line += (f"; in turns captured at world 1 {d:.3f} ms against "
                     f"the single-device step {sd:.3f} ms ({d - sd:+.3f} ms)")
        if "turn_on" in v:
            on, off = v["turn_on"], v["turn_off"]
            line += (f"; in turns captured with the sentinel {on:.3f} ms "
                     f"against {off:.3f} ms without ({on - off:+.3f} ms, "
                     f"{100 * (on - off) / off:+.1f} %)")
        print(line)


def phase_breakdown(torch, cfg, opt, params, state, batch, sync, reps=3):
    """Host-clock ms of each phase of a step (each ends in a synchronize),
    median of ``reps``: forward+backward, the MKOR+LAMB update, LAMB
    alone on the same gradients, and applying the updates."""
    from repro_torch.core import firstorder
    from repro_torch.training import loop as train_lib

    loss_fn = train_lib.make_loss_fn(cfg)
    lamb = firstorder.lamb(1e-3)
    lamb_state = lamb.init(params)
    times = {"forward+backward": [], "optimizer (MKOR+LAMB)": [],
             "LAMB alone": [], "apply_updates": []}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        (loss, aux), grads = timed("forward+backward",
                                   lambda: train_lib.value_and_grad(
                                       loss_fn, params, batch))
        updates, _ = timed("optimizer (MKOR+LAMB)", lambda: opt.update(
            grads, state, params=params, stats=aux["stats"]))
        timed("LAMB alone", lambda: lamb.update(grads, lamb_state,
                                                params=params))
        timed("apply_updates",
              lambda: firstorder.apply_updates(params, updates))
    print("phase ms (median of 3 steps, host clock): " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in times.items()))


def profile_step(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profiled step: wall {wall:.3f} ms; the profiler recorded no "
              "device time (not measured)")
        return wall, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + (cur_e - cur_s)) / 1e3
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    port = ("mkor::gemm_kernel", "wgmma_gemm_kernel", "sumsq_kernel",
            "sum_parts_kernel", "rescale_kernel", "block_smw_kernel")

    def is_port(n):
        return any(p in n for p in port)

    def is_gemm(n):
        low = n.lower()
        return not is_port(n) and any(t in low for t in (
            "gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas"))

    t_port = sum(v[0] for n, v in by_name.items() if is_port(n))
    t_gemm = sum(v[0] for n, v in by_name.items() if is_gemm(n))
    t_all = sum(v[0] for v in by_name.values())
    print(f"profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), port kernels {t_port:.3f} ms, "
          f"library GEMMs {t_gemm:.3f} ms, other kernels "
          f"{t_all - t_port - t_gemm:.3f} ms")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t:10.3f} ms {c:5d}x  {n[:100]}")
    # host waits: runtime calls that hold the host until the device is done
    # (the step's own closing synchronize is one of them)
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    t_first = min(e.time_range.start for e in host)
    waits = {}
    for e in host:
        if any(k in e.name for k in ("Synchronize", "cudaMemcpy",
                                     "_local_scalar_dense")):
            w = waits.setdefault(e.name, [0.0, 0, math.inf])
            w[0] += (e.time_range.end - e.time_range.start) / 1e3
            w[1] += 1
            w[2] = min(w[2], (e.time_range.start - t_first) / 1e3)
    print("host waits in the step: " + (", ".join(
        f"{n} {c}x {t:.3f} ms (first at +{f:.1f} ms)"
        for n, (t, c, f) in sorted(waits.items())) or "none"))
    return wall, busy


# ----------------------------------------------------------------------- #
# MKOR-H: the sticky switch to first order, eager and captured
# ----------------------------------------------------------------------- #
def make_mkor_h(setup):
    """mkor_h(lamb(1e-3)) through the kernels at inv_freq 3 with min steps
    3 and threshold 1: the rate (slow − fast)/|slow| stays below 1 while
    the loss is finite, so the switch turns off at count 4."""
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor_h
    from repro_torch.training import loop as train_lib
    mcfg = MKORConfig(inv_freq=3, use_kernels=True,
                      hybrid_min_steps=HYBRID_FLIP - 1, hybrid_threshold=1.0)
    opt = mkor_h(firstorder.lamb(1e-3), mcfg)
    return opt, train_lib.make_train_step(setup[0], opt), mcfg


def step_launches(before, after):
    """The kernels of REPLACES launched between two count snapshots."""
    return {k: after.get(k, 0) - before.get(k, 0) for k in REPLACES
            if after.get(k, 0) != before.get(k, 0)}


def train_mkor_h(torch, dev, setup):
    """Path h, eager: HYBRID_STEPS steps; the switch must turn off at
    count HYBRID_FLIP.  The steps up to it launch fused_smw, fused_precond
    and matmul; the eager step reads the switch once a step, so every step
    after it launches no kernel of REPLACES.  The banks stay bit-frozen
    over two inv_freq windows after the flip.  A profiled post-flip step;
    then the (params, state) checkpoint round trip on the card."""
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    cfg, params, ds, _ = setup
    opt, step_fn, mcfg = make_mkor_h(setup)
    # run_path sets the counts to 0 before its first step
    snaps, on, times, frozen = [{}], [], [], {}
    window = HYBRID_FLIP + 2 * mcfg.inv_freq

    def on_step(step, state, ms):
        snaps.append(dict(ops.launch_counts()))
        on.append(bool(state["hybrid"]["on"]))
        times.append(ms)
        if step in (HYBRID_FLIP, window):
            frozen[step] = [t.clone() for t in
                            tree_leaves(state["factor_banks"])]

    params_out, state, counts = run_path(torch, dev, "mkor_h", step_fn,
                                         opt, params, ds, HYBRID_STEPS,
                                         on_step=on_step)
    flip = on.index(False) if False in on else None
    per_step = [step_launches(a, b) for a, b in zip(snaps, snaps[1:])]
    print(f"[mkor_h] the switch after each step {on}: off from count "
          f"{flip} (required {HYBRID_FLIP}); launches a step {per_step}")
    require(flip == HYBRID_FLIP and not any(on[flip:]),
            f"mkor_h: the switch turned off at count {flip}, not "
            f"{HYBRID_FLIP}, or turned back on")
    for i, c in enumerate(per_step):
        if i <= flip:
            require(all(c.get(k, 0) > 0 for k in PATH_KERNELS["mkor_h"][0]),
                    f"mkor_h: step {i}, before the host saw the flip, "
                    f"launched {c}")
        else:
            require(not c, f"mkor_h: step {i}, after the host saw the "
                    f"flip, launched {c}")
    same = all(torch.equal(a, b) for a, b in
               zip(frozen[HYBRID_FLIP], frozen[window]))
    print(f"[mkor_h] banks after count {HYBRID_FLIP} against count "
          f"{window} (two inv_freq windows): "
          f"{'bit-frozen' if same else 'MOVED'}")
    require(same, "mkor_h: the banks moved after the flip")
    del frozen
    pre = statistics.median(times[1:flip + 1])
    post = statistics.median(times[flip + 1:])
    print(f"[mkor_h] eager step ms median: steps 1-{flip} (switch on) "
          f"{pre:.3f}, steps {flip + 1}-{HYBRID_STEPS - 1} (off) "
          f"{post:.3f}")
    SUMMARY["mkor_h"].update(eager_pre_ms=pre, eager_ms=post)
    profile_and_phases_h(torch, dev, ds, step_fn, params_out, state)
    checkpoint_round_trip(torch, params_out, state)
    return counts, opt, step_fn


def profile_and_phases_h(torch, dev, ds, step_fn, params, state):
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, HYBRID_STEPS),
                                      dev)
    SUMMARY["mkor_h"]["eager_busy"] = profile_step(
        torch, lambda: step_fn(params, state, batch))


def checkpoint_round_trip(torch, params, state):
    """The full-width (params, state) saved into a temporary directory,
    restored with ``restore_latest_valid`` onto the card, every leaf
    ``torch.equal``; bytes and seconds printed, the directory removed."""
    import tempfile
    from repro_torch import checkpointing
    from repro_torch.tree import tree_leaves
    tree = (params, state)
    with tempfile.TemporaryDirectory(prefix="mkor_ckpt_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = checkpointing.save(d, HYBRID_STEPS - 1, tree,
                                 {"step": HYBRID_STEPS - 1})
        t_save = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in Path(out).iterdir())
        t0 = time.perf_counter()
        restored = checkpointing.restore_latest_valid(d, tree)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    require(restored is not None and restored[2] == HYBRID_STEPS - 1,
            "checkpoint: nothing valid restored")
    got, want = tree_leaves(restored[0]), tree_leaves(tree)
    equal = len(got) == len(want) and all(
        a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(got, want))
    print(f"[mkor_h] checkpoint of (params, state) at full width: "
          f"{len(want)} leaves, {n_bytes:,} bytes, save {t_save:.3f} s, "
          f"restore {t_restore:.3f} s onto {want[0].device}; every leaf "
          f"torch.equal: {equal}")
    require(equal, "checkpoint: a restored leaf differs")
    SUMMARY["mkor_h"]["ckpt"] = (n_bytes, t_save, t_restore)


def graph_mkor_h(torch, dev, setup, step_fn, opt):
    """Path h, captured: from a copy of the step-0 state, HYBRID_STEPS
    steps in chunks of HYBRID_CHUNK through the chunk runner, so the switch
    turns off inside the second chunk: every replay held against the eager
    step from the same state (:class:`ReplayCheck`).  The runner reads the
    switch once a chunk, so the replays of the chunks after the flip's
    credit no launch of REPLACES, and the replays before them credit
    fused_smw, fused_precond and matmul.  Then replays alone, from a fresh
    copy of the step-0 state: before the flip and after it; a profiled
    post-flip replay.  Returns (counts, runner, params, state)."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_map
    cfg, params0, ds, _ = setup
    gname = "mkor_h[graph]"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    runner = train_lib.make_chunk_runner(step_fn)
    check = ReplayCheck(torch, runner, step_fn, gname, True)
    batches = [pipeline.make_batch(ds, i) for i in range(HYBRID_STEPS)]
    params, state, hist = train_lib.train_epoch(
        step_fn, tree_map(torch.clone, params0), opt.init(params0), batches,
        chunk=HYBRID_CHUNK, runner=runner)
    counts = ops.launch_counts()
    cores = ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    losses = [h["loss"] for h in hist]
    print(f"[{gname}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses),
            f"{gname}: non-finite loss")
    n_graphs = 3 + 1        # a residue each while on, one once off
    n_first = 3 + 1         # each graph's first step runs eagerly
    require(len(runner.graphs) == n_graphs and
            check.n == HYBRID_STEPS - n_first,
            f"{gname}: {len(runner.graphs)} graphs, {check.n} replays")
    require(not bool(state["hybrid"]["on"]) and
            int(state["count"]) == HYBRID_STEPS,
            f"{gname}: the switch is on or the count is "
            f"{int(state['count'])}")
    check.report()
    after = 2 * HYBRID_CHUNK        # the first count of the chunk after
    print(f"[{gname}] {len(runner.graphs)} graphs, keys "
          f"{sorted(map(str, runner.graphs))}; launch counts {counts}, GEMM "
          f"cores {cores}, fallbacks {fallbacks}; each replay's credited "
          f"launches {check.per_replay}")
    for count, c in check.per_replay:
        c = {k: v for k, v in c.items() if k in REPLACES and v}
        if count >= after:
            require(not c, f"{gname}: the replay at count {count}, after "
                    f"the flip's chunk, launched {c}")
        else:
            require(all(c.get(k, 0) > 0 for k in PATH_KERNELS["mkor_h"][0]),
                    f"{gname}: the replay at count {count} launched {c}")
    require(any(k >= after for k, _ in check.per_replay) and
            any(k < after for k, _ in check.per_replay),
            f"{gname}: replays on one side of the flip only")
    must, must_not = PATH_KERNELS["mkor_h"]
    for k in must:
        require(check.replay_counts.get(k, 0) > 0,
                f"{gname}: {k} was not launched under replay")
    for k in must_not:
        require(counts.get(k, 0) == 0, f"{gname}: {k} was launched")
    require(not fallbacks, f"{gname}: fallbacks on the path: {fallbacks}")
    gemms = sum(counts.get(k, 0) for k in GEMM_KERNELS)
    require(cores.get("wmma", 0) == 0 and cores.get("wgmma", 0) == gemms,
            f"{gname}: GEMM cores {cores}, expected all {gemms} on wgmma")
    del runner._replay, check, params, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # replays alone from a fresh copy of the step-0 state (the first call
    # copies it into the static buffers, so its time is dropped)
    params, state = tree_map(torch.clone, params0), opt.init(params0)
    times = []
    for i in range(HYBRID_STEPS - 1):
        t0 = time.perf_counter()
        params, state, _ = runner(params, state, _one_step(ds, i))
        times.append((time.perf_counter() - t0) * 1e3)
    require(not bool(state["hybrid"]["on"]), f"{gname}: the switch is on")
    alloc = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    reserved = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    pre = statistics.median(times[1:HYBRID_FLIP + 1])
    post = statistics.median(times[HYBRID_FLIP + 1:])
    print(f"[{gname}] replays alone from the step-0 state: step ms "
          f"{[round(t, 3) for t in times]}; median counts 1-{HYBRID_FLIP} "
          f"(switch on, masked) {pre:.3f} ms, counts {HYBRID_FLIP + 1}-"
          f"{len(times) - 1} (off) {post:.3f} ms; peak memory {alloc:.3f} "
          f"GiB allocated, {reserved:.3f} GiB reserved")
    out = {}
    batch = _one_step(ds, HYBRID_STEPS - 1)

    def one():
        out["step"] = runner(params, state, batch)
    busy = profile_step(torch, one)
    params, state, _ = out.pop("step")
    SUMMARY["mkor_h"].update(graph_ms=post, graph_pre_ms=pre,
                             graph_busy=busy, graph_alloc=alloc,
                             graph_reserved=reserved,
                             graphs=len(runner.graphs))
    return counts, runner, params, state


def turns_mkor_h(torch, dev, setup, runner, params, state):
    """The post-flip captured step in turns with LAMB alone's captured
    step (post-flip, LAMB, LAMB, post-flip), TURN_STEPS one-step chunks
    each, each turn's median dropping its first step."""
    from repro_torch.core import firstorder
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_map
    cfg, params0, ds, _ = setup
    lamb = firstorder.lamb(1e-3)
    lamb_step = train_lib.make_train_step(cfg, lamb)
    lamb_runner = train_lib.make_chunk_runner(lamb_step)
    lp, ls, _ = lamb_runner(tree_map(torch.clone, params0),
                            lamb.init(params0), _one_step(ds, 0))
    i, medians = HYBRID_STEPS, {"mkor_h": [], "lamb": []}
    for kind in ("mkor_h", "lamb", "lamb", "mkor_h"):
        times = []
        for _ in range(TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "lamb":
                lp, ls, _ = lamb_runner(lp, ls, _one_step(ds, i))
            else:
                params, state, _ = runner(params, state, _one_step(ds, i))
            times.append((time.perf_counter() - t0) * 1e3)
            i += 1
        med = statistics.median(times[1:])
        medians[kind].append(med)
        print(f"[mkor_h turns] {'post-flip' if kind == 'mkor_h' else kind}:"
              f" step ms {[round(t, 3) for t in times]}, median of steps "
              f"2-{TURN_STEPS} {med:.3f}")
    post = statistics.median(medians["mkor_h"])
    lamb_ms = statistics.median(medians["lamb"])
    print(f"[mkor_h turns] median over both turns: MKOR-H after the flip "
          f"{post:.3f} ms, LAMB alone {lamb_ms:.3f} ms (captured)")
    SUMMARY["mkor_h"].update(turn_post=post, turn_lamb=lamb_ms)


def mkor_h_path(torch, dev, setup):
    """Phases 4 and 5 of path h (MKOR-H); returns its launch counts."""
    t0 = time.perf_counter()
    counts, opt, step_fn = train_mkor_h(torch, dev, setup)
    torch.cuda.empty_cache()
    print(f"[mkor_h] path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g_counts, runner, params, state = graph_mkor_h(torch, dev, setup,
                                                   step_fn, opt)
    turns_mkor_h(torch, dev, setup, runner, params, state)
    del runner, params, state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mkor_h[graph]] path done in {time.perf_counter() - t0:.1f} s")
    return collections.Counter(counts) + collections.Counter(g_counts)


# ----------------------------------------------------------------------- #
# The health sentinel and the chaos harness (paths i and j)
# ----------------------------------------------------------------------- #
# per path: the MKORConfig fields beside health=True, the steps, the path
# without the sentinel it is timed against in turns, and its injections as
# (site, count, the phase of the target bucket): off-phase for the target
# (the reference's test docstring: on a phase step of staleness 1 the
# promote would erase the poison), except path i's Inf into the bucket of
# phase 2 on its phase step 2, which hands the poisoned bank to
# fused_block_smw on the step the gate rejects
HEALTH_SPECS = {
    "health": dict(kw=dict(rank=4, inv_freq=4), steps=HEALTH_STEPS,
                   off="rank4", inject=(("factor_inf", 2, 2),
                                        ("grad_nan", 5, 0),
                                        ("factor_inf", 6, 1))),
    "int8_health": dict(kw=dict(factor_quant="int8", inv_freq=3),
                        steps=INT8_HEALTH_STEPS, off="int8_rank1",
                        inject=(("grad_nan", 4, 0),)),
}


def health_of(state):
    """{bucket: (trips, cooldown)} (device reads, outside any step)."""
    return {b: (int(h["trips"]), int(h["cooldown"]))
            for b, h in sorted(state["health"].items())}


def expected_health(phases, inv_freq, cooldown, trips_at, steps):
    """Each bucket's (trips, cooldown) after each step, on the host: an
    injection trips its bucket alone and sets the cooldown; each of the
    bucket's phase steps after it takes one off."""
    trips = {b: 0 for b in phases}
    cool = dict(trips)
    out = []
    for c in range(steps):
        for b, ph in phases.items():
            if (c, b) in trips_at:
                trips[b], cool[b] = trips[b] + 1, cooldown
            elif c % inv_freq == ph:
                cool[b] = max(cool[b] - 1, 0)
        out.append({b: (trips[b], cool[b]) for b in sorted(phases)})
    return out


def reentry(count, phase, inv_freq, cooldown):
    """The phase step at which a bucket tripped at ``count`` inverts
    again: the (cooldown + 1)-th of its phase steps after the trip."""
    c, left = count, cooldown + 1
    while left:
        c += 1
        left -= c % inv_freq == phase
    return c


def is_reset(torch, bank):
    """The bucket's bank is the exact quarantine reset: identity bits; for
    int8, codes 127·I, every scale 1/127 in fp32 and zero error
    feedback."""
    for side in ("l", "r"):
        q = bank[f"{side}_inv"]
        eye = torch.eye(q.shape[-1], device=q.device)
        eye = (eye * 127 if q.dtype == torch.int8 else eye).to(q.dtype)
        if not torch.equal(q, eye.expand(q.shape)):
            return False
        if f"{side}_scale" in bank:
            sc = bank[f"{side}_scale"]
            if not torch.equal(sc, torch.full_like(sc, 1.0 / 127)) or \
                    bool(bank[f"{side}_ef"].any()):
                return False
    return True


def health_plan(setup, name, mcfg):
    """The path's chaos plan, its injections as (site, count, bucket) and
    the buckets' phases."""
    from repro_torch.training import chaos as chaos_lib
    phases = _phases(setup[1], mcfg)
    by_phase = {}
    for b, ph in sorted(phases.items()):
        by_phase.setdefault(ph, b)
    inj = []
    for site, count, ph in HEALTH_SPECS[name]["inject"]:
        require(ph in by_phase, f"{name}: no bucket of phase {ph} "
                f"({phases})")
        inj.append((site, count, by_phase[ph]))
    plan = chaos_lib.ChaosPlan(tuple(
        chaos_lib.Injection(site=site, step=c, bucket=b)
        for site, c, b in inj))
    print(f"[{name}] buckets and phases {phases}; injections "
          + ", ".join(f"{site}@{c}:{b} ("
                      f"{'on' if c % mcfg.inv_freq == phases[b] else 'off'}"
                      f"-phase)" for site, c, b in inj))
    return plan, inj, phases


def health_step0(torch, dev, setup, name):
    """Step 0 from the same state with the sentinel on and off (no chaos):
    banks and windows torch.equal, no trip, the loss equal, params and
    LAMB's moments within ``replay_tol`` (fused_precond's atomics)."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    kw = HEALTH_SPECS[name]["kw"]
    opt_on, step_on, _ = make(True, health=True, **kw)
    opt_off, step_off, _ = make(True, **kw)
    batch0 = train_lib.batch_to_device(pipeline.make_batch(ds, 0), dev)
    s_off0 = opt_off.init(params)
    p_on, s_on, m_on = step_on(params, opt_on.init(params), batch0)
    p_off, s_off, m_off = step_off(params, s_off0, batch0)
    torch.cuda.synchronize()
    got = dict(flat_paths({"params": p_on, "state": {
        k: v for k, v in s_on.items() if k != "health"}}))
    want = dict(flat_paths({"params": p_off, "state": s_off}))
    old = {"params": params, "state": s_off0}
    require(sorted(got, key=str) == sorted(want, key=str),
            f"{name} step 0: the trees differ")
    equal = bounded = 0
    worst = 0.0
    for path, w in want.items():
        g = got[path]
        if torch.equal(g, w):
            equal += 1
            continue
        tag = "/".join(map(str, path))
        require(may_differ(path), f"{name} step 0: {tag} differs with the "
                "sentinel on, and must be bit for bit")
        o = old
        for k in path:
            o = o[k]
        ratio = float(((g.float() - w.float()).abs()
                       / replay_tol(path, w, o)).max())
        worst = max(worst, ratio)
        bounded += 1
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"{name} step 0: {tag} at {ratio:.3f} of its bound")
    trips = health_of(s_on)
    print(f"[{name}] step 0 with the sentinel against without, from the "
          f"same state: {equal} of {len(want)} leaves bit for bit (banks, "
          f"windows, counts), {bounded} within replay_tol (worst "
          f"{worst:.3f}); loss {float(m_on['loss']):.6f} vs "
          f"{float(m_off['loss']):.6f}; health {trips}")
    require(all(t == 0 for t, _ in trips.values()), f"{name} step 0 tripped")
    require(torch.equal(m_on["loss"], m_off["loss"]),
            f"{name} step 0: the loss differs")


class PivotLog:
    """Records the pivot of every ``smw_block_update_banked`` call that
    asks for one (a 0-d device tensor, read after the step)."""

    def __init__(self):
        self.pending, self.by_step = [], {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.kept = ops, ops.smw_block_update_banked

        def logged(*args, **kw):
            res = self.kept(*args, **kw)
            if kw.get("with_pivot"):
                self.pending.append(res[1])
            return res
        ops.smw_block_update_banked = logged
        return self

    def __exit__(self, *exc):
        self.ops.smw_block_update_banked = self.kept

    def step_done(self, step):
        if self.pending:
            self.by_step[step] = min(float(p) for p in self.pending) \
                if all(math.isfinite(float(p)) for p in self.pending) \
                else float("nan")
        self.pending = []


def health_eager(torch, dev, setup, name):
    """Path i / j eager: the chaotic kernel route teed to the plain route
    at each injected bucket's re-entry.  After every step each bucket's
    (trips, cooldown) must be the host's expectation (each trip on its
    step and bucket only, the cooldown counting down on phase steps);
    after an injected step the target's banks are the exact reset and its
    windows and counts zero; at a re-entry the inversion is held against
    the plain route and the banks leave the reset.  Rank 4: the kernel's
    pivot of every phase step, whose minimum over the clean ones must
    reach health_pivot_tol.  Returns (counts, history, plan, mcfg)."""
    from repro_torch.training import chaos as chaos_lib
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_leaves
    cfg, params, ds, make = setup
    spec = HEALTH_SPECS[name]
    opt_k, step_k, mcfg = make(True, health=True, **spec["kw"])
    opt_p, _, _ = make(False, health=True, **spec["kw"])
    plan, inj, phases = health_plan(setup, name, mcfg)
    f, k_cool = mcfg.inv_freq, mcfg.health_cooldown
    trips_at = {(c, b) for _, c, b in inj}
    want = expected_health(phases, f, k_cool, trips_at, spec["steps"])
    back = {b: reentry(c, phases[b], f, k_cool) for _, c, b in inj}
    require(max(back.values()) < spec["steps"],
            f"{name}: re-entries {back} beyond the run")
    tee_at = sorted(set(back.values()))
    quant8 = mcfg.factor_quant == "int8"
    check = Int8BankCheck(torch) if quant8 else None
    tee = PlainTee(torch, opt_k, opt_p, phases, f, update_at=tee_at,
                   compare=check, block=block_update_f64 if quant8 else None)
    opt = chaos_lib.chaotic(tee.transformation(), plan, mcfg)
    step_fn = train_lib.make_train_step(cfg, opt)
    hist = []
    pivots = PivotLog()

    def on_step(step, state, ms):
        pivots.step_done(step)
        got = health_of(state)
        hist.append(got)
        require(got == want[step], f"{name}: after step {step} health "
                f"{got}, expected {want[step]}")
        for site, c, b in inj:
            if c == step:
                wins = state.get("stat_windows", {}).get(b, {})
                clear = all(not bool(t.any()) for t in wins.values())
                ok = is_reset(torch, state["factor_banks"][b]) and clear \
                    and (not mcfg.staleness or is_reset(
                        torch, state["pending_banks"][b]))
                print(f"[{name}] step {step} ({site} into {b}): trips "
                      f"{got[b][0]}, cooldown {got[b][1]}; banks the exact "
                      f"reset, windows and counts zero: {ok}")
                require(ok, f"{name}: step {step} left {b} unreset")
        for b, c in back.items():
            if c == step:
                left = not is_reset(torch, state["factor_banks"][b])
                print(f"[{name}] step {step}: {b} re-entered (cooldown "
                      f"{got[b][1]}), its banks left the reset: {left}")
                require(left, f"{name}: {b} did not re-enter at {step}")

    with pivots:
        params_out, state, counts = run_path(
            torch, dev, name, step_fn, opt, params, ds, spec["steps"],
            skip_times=tee_at, on_step=on_step)
    require(tee.compared == tee_at, f"{name}: compared at {tee.compared}, "
            f"expected {tee_at}")
    if check is not None:
        check.summary(name)
    require(all(bool(torch.isfinite(t).all())
                for t in tree_leaves(params_out)),
            f"{name}: a parameter is not finite")
    print(f"[{name}] every loss and parameter finite; health after each "
          f"step as expected ({len(hist)} steps)")
    if mcfg.rank > 1:
        poisoned = {c for site, c, b in inj if c % f == phases[b]}
        clean = {c: p for c, p in pivots.by_step.items()
                 if c not in poisoned}
        low = min(clean.values())
        print(f"[{name}] fused_block_smw pivot, min over both sides a phase "
              f"step: {pivots.by_step}; min over the clean phase steps "
              f"{low:.6g} (health_pivot_tol {mcfg.health_pivot_tol:g}); "
              f"the poisoned steps {sorted(poisoned)} masked by the gate")
        require(len(clean) >= f and math.isfinite(low) and
                low >= mcfg.health_pivot_tol,
                f"{name}: the pivots of the clean phase steps {clean}")
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params_out,
                       state, spec["steps"], name)
    return counts, hist, plan, mcfg


def health_graph(torch, dev, setup, name, plan, mcfg, eager_hist):
    """Path i / j captured with its injections from the step-0 state, in
    chunks of inv_freq: every replay held against the eager step
    (:class:`ReplayCheck`), the health after each replay and at the end
    equal to the eager run's, one graph a residue (the hits ride plan
    scalars), PATH_KERNELS launched under replay."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import chaos as chaos_lib
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_leaves, tree_map
    cfg, params0, ds, make = setup
    spec, gname = HEALTH_SPECS[name], f"{name}[graph]"
    opt_k, _, _ = make(True, health=True, **spec["kw"])
    step_fn = train_lib.make_train_step(cfg, chaos_lib.chaotic(opt_k, plan,
                                                               mcfg))
    f, steps = mcfg.inv_freq, spec["steps"]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    runner = train_lib.make_chunk_runner(step_fn)
    check = ReplayCheck(torch, runner, step_fn, gname, True)
    seen = {}
    check.on_replay = lambda c, p, s: seen.__setitem__(c, health_of(s))
    batches = [pipeline.make_batch(ds, i) for i in range(steps)]
    params, state, hist = train_lib.train_epoch(
        step_fn, tree_map(torch.clone, params0), opt_k.init(params0),
        batches, chunk=f, runner=runner)
    counts = ops.launch_counts()
    cores = ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    losses = [h["loss"] for h in hist]
    print(f"[{gname}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses),
            f"{gname}: non-finite loss")
    require(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
            f"{gname}: a parameter is not finite")
    require(len(runner.graphs) == f and check.n == steps - f,
            f"{gname}: {len(runner.graphs)} graphs, {check.n} replays")
    check.report()
    bad = {c: h for c, h in seen.items() if h != eager_hist[c]}
    print(f"[{gname}] {len(runner.graphs)} graphs (one a residue), keys "
          f"{sorted(map(str, runner.graphs))}; health after each of "
          f"{len(seen)} replays as in the eager run: {not bad}; at the end "
          f"{health_of(state)}; launch counts {counts} (replays alone "
          f"{dict(check.replay_counts)}), GEMM cores {cores}, fallbacks "
          f"{fallbacks}")
    require(not bad and health_of(state) == eager_hist[-1],
            f"{gname}: health differs from the eager run at {bad}")
    must, must_not = PATH_KERNELS[name]
    for k in must:
        require(check.replay_counts.get(k, 0) > 0,
                f"{gname}: {k} was not launched under replay")
    for k in must_not:
        require(counts.get(k, 0) == 0, f"{gname}: {k} was launched")
    require(not fallbacks, f"{gname}: fallbacks on the path: {fallbacks}")
    gemms = sum(counts.get(k, 0) for k in GEMM_KERNELS)
    require(cores.get("wmma", 0) == 0 and cores.get("wgmma", 0) == gemms,
            f"{gname}: GEMM cores {cores}, expected all {gemms} on wgmma")
    del runner._replay, check, runner, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def health_turns(torch, dev, setup, name):
    """The sentinel's cost, captured, no injection: the step with
    health=True from the step-0 state through its own chunk runner (its
    inv_freq first steps capture the graphs), then 2 x inv_freq replays
    alone (step times, peak allocated and reserved memory with no other
    runner alive) and a profiled replay; then the same config without the
    sentinel (the path of HEALTH_SPECS' ``off``), brought to the same
    count, and the two in turns (on, off, off, on; TURN_STEPS one-step
    chunks each, each turn's median dropping its first step)."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_map
    cfg, params0, ds, make = setup
    spec = HEALTH_SPECS[name]
    f = spec["kw"]["inv_freq"]

    def start(health):
        opt, step, _ = make(True, health=health, **spec["kw"])
        runner = train_lib.make_chunk_runner(step)
        stacked = train_lib.stack_batches([pipeline.make_batch(ds, i)
                                           for i in range(f)])
        p, s, _ = runner(tree_map(torch.clone, params0), opt.init(params0),
                         stacked)
        return runner, [p, s]

    run_on, on = start(True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, i = [], f
    for _ in range(2 * f):
        t0 = time.perf_counter()
        on[0], on[1], _ = run_on(*on, _one_step(ds, i))
        times.append((time.perf_counter() - t0) * 1e3)
        i += 1
    alloc = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    reserved = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    median = statistics.median(times)
    print(f"[{name}[graph]] with the sentinel, no injection, replays alone "
          f"from the step-0 state, counts {f}-{i - 1}: step ms "
          f"{[round(t, 3) for t in times]} (median {median:.3f} ms), peak "
          f"memory {alloc:.3f} GiB allocated, {reserved:.3f} GiB reserved")
    out = {}
    batch = _one_step(ds, i)

    def one():
        out["step"] = run_on(*on, batch)
    busy = profile_step(torch, one)
    on[0], on[1], _ = out.pop("step")
    i += 1
    SUMMARY[name].update(graph_ms=median, graph_busy=busy,
                         graph_alloc=alloc, graph_reserved=reserved,
                         graphs=len(run_on.graphs))
    run_off, off = start(False)
    j = f
    while j < i:                    # to the count the sentinel's run is at
        off[0], off[1], _ = run_off(*off, _one_step(ds, j))
        j += 1
    medians, at = {True: [], False: []}, {True: i, False: i}
    for health in (True, False, False, True):
        runner, st = (run_on, on) if health else (run_off, off)
        times, k = [], at[health]
        for _ in range(TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st[0], st[1], m = runner(*st, _one_step(ds, k))
            times.append((time.perf_counter() - t0) * 1e3)
            k += 1
        require(all(math.isfinite(float(x)) for x in m["loss"]),
                f"{name} turns: non-finite loss")
        med = statistics.median(times[1:])
        medians[health].append(med)
        print(f"[{name} turns] {'with' if health else 'without'} the "
              f"sentinel, counts {at[health]}-{k - 1}: step ms "
              f"{[round(t, 3) for t in times]}, median of steps 2-"
              f"{TURN_STEPS} {med:.3f}")
        at[health] = k
    t_on, t_off = (statistics.median(medians[h]) for h in (True, False))
    print(f"[{name} turns] median over both turns: with the sentinel "
          f"{t_on:.3f} ms, without {t_off:.3f} ms ({t_on - t_off:+.3f} ms, "
          f"{100 * (t_on - t_off) / t_off:+.1f} %), captured")
    # no injection here: a trip would be the sentinel's own verdict (a
    # bank grown past health_norm_factor x stabilizer_threshold), printed
    print(f"[{name} turns] health at count {at[True]}: {health_of(on[1])}")
    SUMMARY[name].update(turn_on=t_on, turn_off=t_off)
    del run_on, run_off, on, off
    gc.collect()
    torch.cuda.empty_cache()


def health_path(torch, dev, setup, name):
    """Phases 4 and 5 of path i or j; returns its launch counts."""
    t0 = time.perf_counter()
    health_step0(torch, dev, setup, name)
    counts, hist, plan, mcfg = health_eager(torch, dev, setup, name)
    torch.cuda.empty_cache()
    print(f"[{name}] path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g_counts = health_graph(torch, dev, setup, name, plan, mcfg, hist)
    health_turns(torch, dev, setup, name)
    print(f"[{name}[graph]] path done in {time.perf_counter() - t0:.1f} s")
    return collections.Counter(counts) + collections.Counter(g_counts)


# ----------------------------------------------------------------------- #
# The per-layer layout (paths k, l) and the baselines (paths m, n)
# ----------------------------------------------------------------------- #
def bank_state_of(torch, state, params, mcfg):
    """The bank layout's state carrying a per-layer state's factors (each
    bucket's slots stacked in the manifest's order), its count, switch and
    backend (rank 1 at staleness 0: no windows)."""
    from repro_torch.core.mkor import manifest_for
    banks = {b.bucket_id: {side: torch.stack([state["factors"][ps][side]
                                              for ps in b.path_strs])
                           for side in ("l_inv", "r_inv")}
             for b in manifest_for(params, mcfg)}
    return {"count": state["count"], "factor_banks": banks,
            "hybrid": state["hybrid"], "backend": state["backend"]}


def _moments(tree, state):
    return {"params": tree, "state": {"backend": {
        k: state["backend"][k] for k in ("m", "v")}}}


def train_per_layer_rank1(torch, dev, setup, rank1_counts):
    """Path k: the per-layer layout at rank 1 (inv_freq 3, stagger)
    through the per-layer kernel entries, PER_LAYER_STEPS steps.  After
    each per-layer step, the bank path's step (path a's optimizer) runs
    from the same state, the factors carried across (per-layer → bank
    slices), its launches set aside: the factors after the SMW must be
    ``torch.equal`` (else within the elementwise bf16 bound; which held is
    printed), params and LAMB's moments within ``replay_tol``
    (fused_precond's ΣΔ² atomics).  Launches, losses, step time and peak
    memory are the per-layer steps' alone; fused_precond must launch twice
    as often as on path a (6 layer paths in 3 buckets).  Returns (counts,
    (step_fn, params, state))."""
    from repro_torch.core.mkor import factor_slices
    from repro_torch.data import pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.training import loop as train_lib
    name = "per_layer_rank1"
    cfg, params, ds, make = setup
    opt_l, step_l, _ = make(True, layout="per_layer")
    _, step_b, mcfg_b = make(True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    state = opt_l.init(params)
    losses, times, peaks = [], [], []
    total = collections.Counter()
    worst = collections.defaultdict(float)
    for step in range(PER_LAYER_STEPS):
        batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new_p, new_s, metrics = step_l(params, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        losses.append(float(metrics["loss"]))
        mark = build.count_mark()
        pb, sb, mb = step_b(params, bank_state_of(torch, state, params,
                                                  mcfg_b), batch)
        torch.cuda.synchronize()
        build.rewind_counts(mark)
        tally = collections.Counter()
        bank = factor_slices(sb, params, mcfg_b)
        for key, fac in sorted(new_s["factors"].items()):
            for side in ("l_inv", "r_inv"):
                if torch.equal(fac[side], bank[key][side]):
                    tally["sides equal"] += 1
                    continue
                _, ratio = bf16_close(fac[side], bank[key][side])
                tally["sides within the bf16 bound"] += 1
                worst["factors"] = max(worst["factors"], ratio)
                require(math.isfinite(ratio) and ratio <= 1.0,
                        f"{name}: step {step} {key}/{side} differs from "
                        "the bank path's")
        got = dict(flat_paths(_moments(new_p, new_s)))
        old = dict(flat_paths(_moments(params, state)))
        for path, w in flat_paths(_moments(pb, sb)):
            if torch.equal(got[path], w):
                tally["leaves equal"] += 1
                continue
            tally["leaves within replay_tol"] += 1
            tol = replay_tol(path, w, old[path])
            ratio = float(((got[path].float() - w.float()).abs()
                           / tol).max())
            kind = "params" if path[0] == "params" else f"LAMB {path[2]}"
            worst[kind] = max(worst[kind], ratio)
            require(math.isfinite(ratio) and ratio <= 1.0,
                    f"{name}: step {step} {'/'.join(map(str, path))} "
                    f"differs from the bank path's by {ratio:.3f} of "
                    "replay_tol")
        print(f"[{name}] step {step}: loss {losses[-1]:.6f} (bank path "
              f"{float(mb['loss']):.6f}); against the bank path's step from "
              f"the same state: {dict(tally)}")
        total.update(tally)
        params, state = new_p, new_s
        del pb, sb, mb, bank, got, old, new_p, new_s
    counts = ops.launch_counts()
    print(f"[{name}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss")
    median = statistics.median(times[1:])
    print(f"[{name}] step ms {[round(t, 3) for t in times]} (median of steps "
          f"1-{PER_LAYER_STEPS - 1} {median:.3f} ms; the bank path's steps "
          f"beside them untimed), peak memory "
          f"{max(peaks) / 2 ** 30:.3f} GiB (the per-layer steps')")
    print(f"[{name}] against the bank path over {PER_LAYER_STEPS} steps: "
          f"{dict(total)}; worst ratio to the bound by kind "
          f"{dict(worst) or 'none'} (tol 1)")
    SUMMARY[name]["eager_ms"] = median
    SUMMARY[name]["eager_peak"] = max(peaks) / 2 ** 30
    require_path_kernels(name, counts, ops.gemm_core_counts(),
                         ops.fallback_counts())
    for k in ("fused_precond", "fused_smw"):
        print(f"[{name}] {k} launches {counts.get(k, 0)}, path a's "
              f"{rank1_counts.get(k, 0)} over the same steps "
              f"({counts.get(k, 0) / max(rank1_counts.get(k, 0), 1):.2f}x)")
    require(counts.get("fused_precond", 0) ==
            2 * rank1_counts.get("fused_precond", 0),
            f"{name}: fused_precond launched {counts.get('fused_precond')} "
            f"times, not twice path a's {rank1_counts.get('fused_precond')}")
    profile_and_phases(torch, dev, cfg, ds, step_l, opt_l, params, state,
                       PER_LAYER_STEPS, name)
    return counts, (step_l, params, state)


def train_per_layer_rank4_stale1(torch, dev, setup):
    """Path l: the per-layer layout at block rank 4 with staleness 1
    (inv_freq 4, stagger), PER_LAYER4_STEPS steps: precompute runs before
    each forward pass, and every tick's launched factors (the pending
    factors of the layers that tick) are held against the plain route
    from the same state, as on path c; each layer's second tick consumes
    a full window, so its pending factors leave the identity.  Returns
    the launch counts."""
    from repro_torch.core import stats as statlib
    from repro_torch.core.mkor import manifest_for
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib
    name = "per_layer_rank4_stale1"
    cfg, params, ds, make = setup
    kw = dict(layout="per_layer", rank=4, staleness=1, inv_freq=4)
    opt_k, _, mcfg = make(True, **kw)
    opt_p, _, _ = make(False, **kw)
    phases = statlib.layer_phases(manifest_for(params, mcfg), mcfg.inv_freq,
                                  mcfg.stagger)
    ticks = [c for c in range(PER_LAYER4_STEPS)
             if c % mcfg.inv_freq in set(phases.values())]
    tee = PlainTee(torch, opt_k, opt_p, phases, mcfg.inv_freq, tick_at=ticks,
                   keys=("factors", "pending_factors"))
    opt = tee.transformation()
    step_fn = train_lib.make_train_step(cfg, opt)
    forward = model_lib.forward

    def traced_forward(*args, **kwargs):
        tee.events.append("forward")
        return forward(*args, **kwargs)

    model_lib.forward = traced_forward
    try:
        params, state, counts = run_path(torch, dev, name, step_fn, opt,
                                         params, ds, PER_LAYER4_STEPS,
                                         skip_times=ticks)
    finally:
        model_lib.forward = forward
    require(tee.events == ["precompute", "forward", "update"]
            * PER_LAYER4_STEPS, f"{name}: call order {tee.events[:6]}...")
    require(tee.compared == ticks, f"{name}: compared at {tee.compared}")
    print(f"[{name}] every step ran precompute, then the forward, then "
          f"update; ticks compared with the plain route {tee.compared}")
    for key, fac in sorted(state["pending_factors"].items()):
        d = fac["l_inv"].shape[-1]
        eye = torch.eye(d, dtype=fac["l_inv"].dtype, device=dev)
        moved = (fac["l_inv"] - eye).abs().max().item()
        print(f"[{name}] pending {key}/l_inv: max |F - I| {moved:.3e}")
        require(moved > 0, f"{name}: pending {key} is still the identity")
    return counts


def _run_launcher(torch, argv, tag):
    """``launch/train.py``'s main in this process, its lines (and those of
    the ranks it spawns, which share this process's standard output)
    printed with ``tag``; returns the logged losses and main's result."""
    import tempfile
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            final = train_cli.main(argv)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            lines = f.read().splitlines()
            for line in lines:
                print(f"[{tag}] {line}")
    torch.cuda.synchronize()
    print(f"[{tag}] {time.perf_counter() - t0:.1f} s in all")
    return [float(ln.split("loss=")[1].split()[0]) for ln in lines
            if ln.startswith("step")], final


def eva_path(torch, dev, setup):
    """Path m: Eva (``eva(lamb)``, EvaConfig()) at full width.  Through
    ``launch/train.py --optimizer eva``: EVA_STEPS steps eagerly
    (``--chunk 1``) and the same in two chunks of 2 (CUDA graph replays);
    every loss finite, no kernel of REPLACES launched.  The first step by
    hand: every ``seen`` false before it and true after; for two layers
    (q and the FFN's output, each all 24 slices) the preconditioned
    gradient handed to LAMB against the float64 dense (aaᵀ + μI)⁻¹ G
    (ggᵀ + μI)⁻¹, rescaled to ‖G‖, within the elementwise bf16 bound.
    Then Eva's step time and memory eager (run_path) and captured
    (graph_path).  Returns the launch counts."""
    from repro_torch.core import stats as statlib
    from repro_torch.core.eva import EvaConfig, eva
    from repro_torch.core.firstorder import GradientTransformation, lamb
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib
    name = "eva"
    cfg, params, ds, _ = setup
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    for chunk in (1, 2):
        tag = f"{name} launcher --chunk {chunk}"
        losses, _ = _run_launcher(torch, [
            "--arch", "bert-large", "--optimizer", "eva", "--steps",
            str(EVA_STEPS), "--chunk", str(chunk), "--log-every", "1"], tag)
        require(len(losses) == EVA_STEPS and
                all(math.isfinite(x) for x in losses),
                f"{tag}: losses {losses}")
        torch.cuda.empty_cache()
    require_path_kernels(name, ops.launch_counts(), ops.gemm_core_counts(),
                         ops.fallback_counts())

    backend = lamb(1e-3)
    handed = {}

    def spy_update(grads, state, **kw):
        handed.setdefault("grads", grads)
        return backend.update(grads, state, **kw)
    ecfg = EvaConfig()
    opt = eva(GradientTransformation(backend.init, spy_update, None,
                                      backend.plan), ecfg)
    state = opt.init(params)
    require(not any(bool(v["seen"]) for v in state["vecs"].values()),
            f"{name}: seen set before the first step")
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, 0), dev)
    (loss, aux), grads = train_lib.value_and_grad(
        train_lib.make_loss_fn(cfg), params, batch)
    _, state = opt.update(grads, state, params=params, stats=aux["stats"],
                          loss=loss)
    seen = [bool(v["seen"]) for v in state["vecs"].values()]
    print(f"[{name}] seen after the first step: {sum(seen)} of {len(seen)} "
          "layers (none before it)")
    require(all(seen), f"{name}: seen not set after the first step")
    paths = {statlib.path_str(p): p for p in statlib.iter_dense_layers(params)}
    for key in ("blocks/0/mixer/q", "blocks/0/mlp/out"):
        a = state["vecs"][key]["a"].double()
        g = state["vecs"][key]["g"].double()
        gw = statlib.tree_get(grads, paths[key])["w"].double()

        def dense_solve(v, x):
            """(vvᵀ + μI)⁻¹ x by a Cholesky factorization of the dense
            matrix (symmetric positive definite), in float64."""
            eye = torch.eye(v.shape[-1], dtype=torch.float64, device=dev)
            chol = torch.linalg.cholesky(v[..., :, None] * v[..., None, :]
                                         + ecfg.damping * eye)
            return torch.cholesky_solve(x, chol)
        want = dense_solve(g, dense_solve(a, gw).transpose(-1, -2)) \
            .transpose(-1, -2)
        want = want * (torch.linalg.vector_norm(gw, dim=(-2, -1),
                                                keepdim=True)
                       / torch.linalg.vector_norm(want, dim=(-2, -1),
                                                  keepdim=True))
        got = statlib.tree_get(handed["grads"], paths[key])["w"]
        err, ratio = bf16_close(got, want)
        print(f"[{name}] first step {key} {tuple(got.shape)} "
              f"{str(got.dtype).removeprefix('torch.')}: against the "
              f"float64 dense (vvᵀ + μI)⁻¹ G (ggᵀ + μI)⁻¹ (Cholesky "
              f"solves), max_abs_err {err:.3e}, "
              f"worst |got-want| / (2^-7|want| + 1e-5 max|want|) "
              f"{ratio:.3f} (tol 1)")
        require(math.isfinite(ratio) and ratio <= 1.0,
                f"{name}: {key}'s preconditioned gradient differs")
        del a, g, gw, want, got
    del handed, grads, aux, state
    torch.cuda.empty_cache()

    opt = eva(lamb(1e-3), ecfg)
    step_fn = train_lib.make_train_step(cfg, opt)
    params, state, counts = run_path(torch, dev, name, step_fn, opt,
                                     params, ds, EVA_STEPS)
    batch = train_lib.batch_to_device(pipeline.make_batch(ds, EVA_STEPS),
                                      dev)
    SUMMARY[name]["eager_busy"] = profile_step(
        torch, lambda: step_fn(params, state, batch))
    g_counts, params, state, runner = graph_path(
        torch, dev, name, step_fn, params, state, ds, EVA_STEPS, 1)
    del params, state, runner
    gc.collect()
    torch.cuda.empty_cache()
    return collections.Counter(counts) + collections.Counter(g_counts)


def _kfac_inverses(torch, tag, state, kcfg):
    """Each layer's KFAC inverses against ``torch.linalg.inv`` of the
    damped covariance in float64: relative Frobenius error within
    d·κ·2^-24 (fp32 eigh of a matrix of condition κ)."""
    worst = 0.0
    for key, fac in sorted(state["factors"].items()):
        for side in ("l", "r"):
            cov = fac[f"{side}_cov"].double()
            d = cov.shape[-1]
            damped = cov + kcfg.damping * torch.eye(
                d, dtype=torch.float64, device=cov.device)
            want = torch.linalg.inv(damped)
            ev = torch.linalg.eigvalsh(damped)
            kappa = float(ev[-1] / ev[0])
            rel = float(torch.linalg.norm(fac[f"{side}_inv"].double() - want)
                        / torch.linalg.norm(want))
            tol = d * kappa * 2.0 ** -24
            worst = max(worst, rel / tol)
            print(f"[baselines] {tag} {key}/{side}_inv ({d}x{d}, κ "
                  f"{kappa:.3f}): relative error {rel:.3e} against float64 "
                  f"inv (tol d·κ·2^-24 = {tol:.3e})")
            require(rel <= tol, f"baselines: {tag} {key}/{side}_inv")
    return worst


def _sngd_dense(torch, stats, grads, scfg):
    """SNGD's first preconditioned gradient at the layers whose dense
    Fisher block is affordable (d_in·d_out ≤ 16384: the 256 x 64 and
    64 x 256 layers), against the dense (F + NμI)⁻¹·N ∇w of
    tests/test_baselines.py in float64 (F = UUᵀ, u_i = vec(a_i g̃_iᵀ)):
    the port's formula run in float64 within width·κ·2^-53 (κ = 1 +
    λmax(UᵀU)/(Nμ), the condition of F + NμI); its fp32 result, which the
    optimizer uses, within c·N·2^-24 of it, c = ‖∇w‖/‖∇w − UZ‖ the
    cancellation in (∇w − UZ)/μ."""
    import importlib
    sngd_lib = importlib.import_module("repro_torch.core.sngd")
    mu = scfg.damping
    for i, layer in enumerate(stats["layers"]):
        gw = grads["layers"][i]["w"]
        width = gw.shape[0] * gw.shape[1]
        if width > 16384:
            continue
        a64, g64, w64 = (x.double() for x in (layer["A"], layer["G"], gw))
        n = a64.shape[0]
        u = (a64[:, :, None] * (g64 * n)[:, None, :]).reshape(n, width)
        fisher = u.T @ u
        fisher.diagonal().add_(n * mu)
        want = (torch.linalg.solve(fisher, w64.reshape(-1)) * n).reshape(
            gw.shape)
        del fisher
        lam = float(torch.linalg.eigvalsh(u @ u.T)[-1])
        kappa = 1.0 + lam / (n * mu)
        f64 = sngd_lib.sngd_precondition(layer["A"].double(),
                                         layer["G"].double(), w64, mu)
        f32 = sngd_lib.sngd_precondition(layer["A"], layer["G"], gw, mu)

        def rel(x):
            return float(torch.linalg.norm(x.double() - want)
                         / torch.linalg.norm(want))
        cancel = float(torch.linalg.norm(w64)
                       / torch.linalg.norm(mu * want))
        tol64 = width * kappa * 2.0 ** -53
        tol32 = cancel * n * 2.0 ** -24
        print(f"[baselines] sngd step 0 layers/{i} ({gw.shape[0]}x"
              f"{gw.shape[1]}, dense width {width}, N {n}, μ {mu}): the "
              f"formula in float64 {rel(f64):.3e} from the dense "
              f"(F + NμI)⁻¹ (tol width·κ·2^-53 = {tol64:.3e}, κ "
              f"{kappa:.3e}); fp32 {rel(f32):.3e} (tol c·N·2^-24 = "
              f"{tol32:.3e}, cancellation c {cancel:.3e})")
        require(rel(f64) <= tol64 and rel(f32) <= tol32,
                f"baselines: sngd layers/{i} differs from the dense form")


def baselines_path(torch, dev):
    """Path n: KFAC (``kfac(sgd(1e-2, momentum 0.9))``, inv_freq 3) and
    SNGD (μ 0.3, as tests/test_baselines.py trains it) on the
    ``baseline_net`` autoencoder (d_in 768, hidden 256/64/256, random
    weights from seed 0, N = 1024 rows of rank-16 data a step),
    BASELINE_STEPS steps each, full statistics from
    ``grads_and_full_stats``: every KFAC inversion held against float64
    ``torch.linalg.inv`` (:func:`_kfac_inverses`), SNGD's first step
    against the dense float64 form (:func:`_sngd_dense`), every loss
    finite, no kernel of REPLACES launched.  Returns the launch counts."""
    import importlib
    from repro_torch.core import baseline_net
    from repro_torch.core.firstorder import apply_updates, sgd
    from repro_torch.kernels import ops
    kfac_lib = importlib.import_module("repro_torch.core.kfac")
    sngd_lib = importlib.import_module("repro_torch.core.sngd")
    name = "baselines"
    d_in, hidden, n_rows = 768, (256, 64, 256), 1024
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = baseline_net.init_autoencoder(gen, d_in, hidden, device=dev)
    basis = torch.randn((16, d_in), generator=gen, device=dev) / 4

    def batch(step):
        g = torch.Generator(device=dev).manual_seed(100 + step)
        x = torch.randn((n_rows, 16), generator=g, device=dev) @ basis
        return {"x": x, "y": x}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    kcfg = kfac_lib.KFACConfig(inv_freq=3, exclude=())
    scfg = sngd_lib.SNGDConfig(damping=0.3, exclude=())
    for tag, opt in (("kfac", kfac_lib.kfac(sgd(1e-2, momentum=0.9), kcfg)),
                     ("sngd", sngd_lib.sngd(sgd(1e-2, momentum=0.9), scfg))):
        params, state = params0, opt.init(params0)
        losses, times = [], []
        torch.cuda.reset_peak_memory_stats()
        for step in range(BASELINE_STEPS):
            b = batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads, stats = baseline_net.grads_and_full_stats(params, b)
            upd, new_state = opt.update(grads, state, params=params,
                                        stats=stats)
            new_params = apply_updates(params, upd)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if tag == "kfac" and step % kcfg.inv_freq == 0:
                _kfac_inverses(torch, f"kfac count {step}", new_state, kcfg)
            if tag == "sngd" and step == 0:
                _sngd_dense(torch, stats, grads, scfg)
            params, state = new_params, new_state
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        median = statistics.median(times[1:])
        print(f"[{name}] {tag} losses {losses}; step ms "
              f"{[round(t, 3) for t in times]} (median of steps 1-"
              f"{BASELINE_STEPS - 1} {median:.3f} ms, checks untimed), "
              f"peak memory {peak:.3f} GiB (with the checks)")
        require(all(math.isfinite(x) for x in losses),
                f"{name}: {tag} non-finite loss")
        SUMMARY[f"{tag} (autoencoder)"].update(eager_ms=median,
                                                eager_peak=peak)
    counts = ops.launch_counts()
    require_path_kernels(name, counts, ops.gemm_core_counts(),
                         ops.fallback_counts())
    return counts


# ----------------------------------------------------------------------- #
# Path o: data parallel (training/loop.py make_dist_train_step,
# MKORConfig(dist=...)'s owner-sharded inversions)
# ----------------------------------------------------------------------- #
def fingerprint(torch, t, block=1 << 24):
    """Two 64-bit sums of a tensor's bit pattern (plain, and weighted by a
    position hash; integer arithmetic, wrapping), ``block`` elements at a
    time: equal tensors give equal pairs, and two that differ in any bit
    give equal pairs only by a 2^-64 chance."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    x = t.detach().contiguous().reshape(-1).view(bits)
    out = torch.zeros((2,), dtype=torch.int64, device=x.device)
    for s0 in range(0, x.numel(), block):
        xs = x[s0:s0 + block].to(torch.int64)
        w = torch.arange(s0, s0 + xs.numel(), device=x.device,
                         dtype=torch.int64) * 2654435761 + 40503
        out += torch.stack([xs.sum(), (xs * w).sum()])
    return out


def dist_world1_path(torch, dev, setup):
    """Path o1: make_dist_train_step over an NCCL group of one rank (the
    launcher's --dist at --dist-devices 1), rank 1, inv_freq 3, eager with
    the bit-tight payload, each step against the single-device step from
    the same state (params, whole state and metrics torch.equal); the
    default bf16 payload eager; captured in chunks of 3 from the eager
    run's final state (every replay against the eager dist step); then the
    captured dist step in turns with the captured single-device step.
    Returns the launch counts."""
    import tempfile
    import torch.distributed as tdist
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor
    from repro_torch.data import pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.training import loop as train_lib
    cfg, params, ds, make = setup
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                 rank=0, world_size=1)
        try:
            dist = (("data", 1),)

            def dist_step(payload):
                opt = mkor(firstorder.lamb(1e-3), MKORConfig(
                    use_kernels=True, inv_freq=3, dist=dist))
                return opt, train_lib.make_dist_train_step(
                    cfg, opt, dist, stats_payload_dtype=payload)
            opt_d, step_d = dist_step(None)
            _, step_s, _ = make(True)
            name = "dist_w1"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            ops.reset_fallback_counts()
            p, s = params, opt_d.init(params)
            times, losses = [], []
            for step in range(DIST_STEPS):
                batch = train_lib.batch_to_device(
                    pipeline.make_batch(ds, step), dev)
                mark = build.count_mark()
                want = step_s(p, s, batch)
                build.rewind_counts(mark)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = step_d(p, s, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(got[2]["loss"]))
                tree = ("params", "state", "metrics")
                g = dict(flat_paths(dict(zip(tree, got))))
                w = dict(flat_paths(dict(zip(tree, want))))
                require(sorted(g, key=str) == sorted(w, key=str),
                        f"{name}: the dist step's tree is not the "
                        "single-device step's")
                bad = [("/".join(map(str, k)),
                        float((g[k].float() - v.float()).abs().max()))
                       for k, v in w.items() if not torch.equal(g[k], v)]
                for tag, diff in bad[:8]:
                    print(f"[{name}] step {step}: {tag} differs from the "
                          f"single-device step by max |diff| {diff:.3e}")
                require(not bad, f"{name}: step {step}: {len(bad)} of "
                        f"{len(w)} leaves differ from the single-device "
                        "step")
                p, s = got[0], got[1]
                del want, got, g, w
            counts = ops.launch_counts()
            require_path_kernels(name, counts, ops.gemm_core_counts(),
                                 ops.fallback_counts())
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            print(f"[{name}] {DIST_STEPS} eager steps over NCCL at world 1, "
                  "bit-tight payload: params, whole optimizer state and "
                  "metrics torch.equal to the single-device step from the "
                  f"same state at every step; losses {losses}; step ms "
                  f"{[round(t, 3) for t in times]} (median of steps 1-"
                  f"{DIST_STEPS - 1} {statistics.median(times[1:]):.3f}); "
                  f"peak memory {peak:.3f} GiB with the comparison copy")
            SUMMARY[name]["eager_ms"] = statistics.median(times[1:])
            SUMMARY[name]["eager_peak"] = peak
            launches.update(counts)

            opt_b, step_b = dist_step("bfloat16")
            _, _, counts = run_path(torch, dev, "dist_w1_bf16", step_b,
                                    opt_b, params, ds, DIST_STEPS)
            launches.update(counts)
            gc.collect()
            torch.cuda.empty_cache()
            g_counts, p, s, runner = graph_path(
                torch, dev, name, step_d, p, s, ds, DIST_STEPS, 3)
            launches.update(g_counts)
            dist_turns(torch, dev, runner, step_s, p, s, ds,
                       int(s["count"]))
            del p, s, runner
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            tdist.destroy_process_group()
    return launches


def dist_turns(torch, dev, runner_d, step_s, params, state, ds, start):
    """The captured dist step at world 1 and the captured single-device
    step in turns (dist, single, single, dist; TURN_STEPS one-step chunks
    each, the first of each turn dropped), from the same state: the cost
    of the collectives' flat-buffer plumbing at world 1.  The two runners
    share their static buffers (the second adopts the first's)."""
    from repro_torch.data import pipeline
    from repro_torch.training import loop as train_lib
    runner_s = train_lib.make_chunk_runner(step_s)
    # capture the single-device step's graphs (one a residue) first
    params, state, _ = runner_s(params, state, train_lib.stack_batches(
        [pipeline.make_batch(ds, start + k) for k in range(3)]))
    i, medians = start + 3, {"dist": [], "single": []}
    for kind in ("dist", "single", "single", "dist"):
        runner = runner_d if kind == "dist" else runner_s
        times = []
        for _ in range(TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, _ = runner(params, state, _one_step(ds, i))
            times.append((time.perf_counter() - t0) * 1e3)
            i += 1
        medians[kind].append(statistics.median(times[1:]))
        print(f"[dist_w1 turns] {kind} captured: step ms "
              f"{[round(t, 3) for t in times]}, median of steps 2-"
              f"{TURN_STEPS} {medians[kind][-1]:.3f}")
    d, s = (statistics.median(medians[k]) for k in ("dist", "single"))
    print(f"[dist_w1 turns] captured dist step at world 1 {d:.3f} ms "
          f"against the single-device step {s:.3f} ms ({d - s:+.3f} ms)")
    SUMMARY["dist_w1"].update(turn_dist=d, turn_single=s)
    del runner_s
    gc.collect()
    torch.cuda.empty_cache()


def dist_launcher_path(torch):
    """Path o3: ``launch/train.py --dist`` as a user runs it (bert-large,
    rank 1, inv_freq 3, the default bf16 stat payload, through the
    kernels), each run against the same launcher without ``--dist``
    (LAUNCH_DIST): one NCCL rank (--dist-devices 1: a spawned process on
    cuda:rank % count) in chunks of 3, so the chunk runner captures the
    collectives; two spawned gloo ranks on the one card at --chunk 1,
    closing with a checkpoint that rank 0 alone writes ("world": 2 in its
    metadata).  Each run's logged losses within LAUNCH_DIST_RTOL of the
    single-device run's, main's result its last loss (rank 0's, through
    the results queue), and one set of log lines (rank 0 alone prints)."""
    import tempfile
    from repro_torch import checkpointing
    from repro_torch.checkpointing import msgpack_codec
    for backend, (extra, steps) in LAUNCH_DIST.items():
        name = f"dist_launcher_{backend}"
        base = ["--arch", "bert-large", "--use-kernels", "--inv-freq", "3",
                "--steps", str(steps), "--log-every", "1"]
        chunk = extra[extra.index("--chunk"):]
        want, _ = _run_launcher(torch, base + chunk, f"{name} single")
        torch.cuda.empty_cache()
        # two ranks share the card (see dist_world2_path); the spawned
        # ranks take the setting from the environment
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            with tempfile.TemporaryDirectory() as ckpt:
                argv = base + ["--dist"] + extra
                if backend == "gloo":
                    argv += ["--ckpt-dir", ckpt]
                t0 = time.perf_counter()
                got, final = _run_launcher(torch, argv, name)
                seconds = time.perf_counter() - t0
                meta = None
                if backend == "gloo":
                    step = checkpointing.latest_step(ckpt)
                    require(step is not None and
                            checkpointing.validate(ckpt, step),
                            f"{name}: no valid checkpoint in --ckpt-dir")
                    meta = msgpack_codec.unpackb(
                        (Path(ckpt) / f"step_{step:08d}" /
                         "manifest.msgpack").read_bytes())["metadata"]
                    require(meta.get("world") == 2,
                            f"{name}: checkpoint metadata {meta}")
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        torch.cuda.empty_cache()
        require(len(got) == len(want) == steps and
                all(math.isfinite(x) for x in got),
                f"{name}: logged losses {got}, single-device {want}")
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        print(f"[{name}] losses {got} against the single-device launcher "
              f"{want}: worst relative difference {worst:.3e} (tol "
              f"{LAUNCH_DIST_RTOL}); main returned {final}"
              + (f"; checkpoint metadata {meta}" if meta else "")
              + f"; {seconds:.1f} s")
        require(worst <= LAUNCH_DIST_RTOL,
                f"{name}: losses differ from the single-device run")
        require(float(f"{final:.4f}") == got[-1], f"{name}: main returned "
                f"{final}, rank 0 logged {got[-1]}")


class DistTee:
    """Wraps a dist MKOR optimizer, keeping what its precompute and update
    were handed (the state before the tick; the mean gradients, stats and
    loss and the state the update saw), so that rank 0 can run the
    single-device optimizer on the same inputs."""

    def __init__(self, opt):
        from repro_torch.core.firstorder import GradientTransformation
        self.rec = {}

        def precompute(state, **kw):
            self.rec["pre"] = (state, kw)
            return opt.precompute(state, **kw)

        def update(grads, state, **kw):
            self.rec["update"] = (grads, state, kw)
            return opt.update(grads, state, **kw)
        self.opt = GradientTransformation(
            opt.init, update,
            precompute if opt.precompute is not None else None, opt.plan,
            opt.observe)


class ChunkLog:
    """The lead dims (flattened) and d of every banked SMW launch, by
    wrapping ops' two banked entries (their behaviour unchanged); while
    ``keep`` is set, their results too."""

    def __init__(self, ops):
        self.launches, self.outputs, self.keep = [], [], False
        for fn_name in ("smw_rank1_update_banked", "smw_block_update_banked"):
            fn = getattr(ops, fn_name)

            def wrapped(j, *a, _fn=fn, **kw):
                n = 1
                for d in j.shape[:-2]:
                    n *= d
                self.launches.append((n, j.shape[-1]))
                out = _fn(j, *a, **kw)
                if self.keep:
                    self.outputs.append(out)
                return out
            setattr(ops, fn_name, wrapped)


def _gather_bytes(torch, t):
    """Both ranks' bytes of ``t`` on the host (rank order), through the
    host-staged gloo all-gather."""
    import torch.distributed as tdist
    host = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    out = torch.empty((2 * host.numel(),), dtype=torch.uint8)
    tdist.all_gather_into_tensor(out, host)
    return out[:host.numel()], out[host.numel():]


def require_replicas(torch, dev, tree, tag):
    """Every leaf's fingerprint against the other rank's (one all-gather
    through the group); returns the number of leaves."""
    import torch.distributed as tdist
    leaves = list(flat_paths(tree))
    fps = torch.stack([fingerprint(torch, t.to(dev))
                       for _, t in leaves]).cpu()
    both = torch.empty((2 * fps.shape[0],) + tuple(fps.shape[1:]),
                       dtype=fps.dtype)
    tdist.all_gather_into_tensor(both, fps)
    diff = [("/".join(map(str, k)))
            for (k, _), a, b in zip(leaves, both[:len(leaves)],
                                    both[len(leaves):])
            if not torch.equal(a, b)]
    require(not diff, f"{tag}: the ranks differ at {diff[:4]} ({len(diff)} "
            "leaves)")
    return len(leaves)


def dist_world2_run(torch, dev, setup, name, kw, steps, rank, log):
    """One o2 run in this rank: ``steps`` eager dist steps through the
    kernels (bit-tight payload).  After every step: the launches (the SMW
    kernel on this rank's chunk of each phase bucket, fused_precond and
    matmul on every slice), replication (each leaf's fingerprint against
    the other rank's), int8 error feedback zero; on phase steps (rank 0)
    the gathered banks against the single-device optimizer on the same
    inputs from the same state.  After the last step every leaf of both
    ranks torch.equal.  ``log``: the :class:`ChunkLog` of the process.
    Returns the launch counts and what held."""
    from repro_torch.core import firstorder, stats as statlib
    from repro_torch.core.mkor import MKORConfig, manifest_for, mkor
    from repro_torch.data import pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.sharding import collectives
    from repro_torch.training import loop as train_lib
    cfg, params, ds, _ = setup
    dist = (("data", 2),)
    kw = {"inv_freq": 3, **kw}
    tee = DistTee(mkor(firstorder.lamb(1e-3), MKORConfig(
        use_kernels=True, dist=dist, **kw)))
    step_d = train_lib.make_dist_train_step(cfg, tee.opt, dist,
                                            stats_payload_dtype=None)
    mcfg = MKORConfig(use_kernels=True, **kw)
    opt_s = mkor(firstorder.lamb(1e-3), mcfg)
    manifest = manifest_for(params, mcfg)
    phases = statlib.bucket_phases(manifest, mcfg.inv_freq, mcfg.stagger)
    slices = {b.bucket_id: statlib.bucket_slices(b) for b in manifest}
    chunks = {}                       # d -> the chunks of buckets with a d side
    for b in manifest:
        for d in (b.d_in, b.d_out):
            chunks.setdefault(d, set()).add(
                collectives.owner_chunk(slices[b.bucket_id], 2))
    quant = kw.get("factor_quant") == "int8"
    smw = ("fused_block_smw" if kw.get("rank", 1) > 1 or kw.get("staleness")
           else "fused_smw") + ("[int8]" if quant else "")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    p, s = params, tee.opt.init(params)
    held = collections.Counter()
    losses, times = [], []
    for step in range(steps):
        batch = train_lib.batch_to_device(pipeline.make_batch(ds, step), dev)
        before = ops.launch_counts()
        log.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, m = step_d(p, s, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        now = ops.launch_counts()
        delta = {k: now.get(k, 0) - before.get(k, 0) for k in now}
        hit = [b for b in manifest if step % mcfg.inv_freq ==
               phases[b.bucket_id]]
        require(delta.get(smw, 0) == 2 * len(hit) and
                len(log.launches) == 2 * len(hit),
                f"{name} rank {rank} step {step}: {delta} with "
                f"{len(hit)} phase buckets")
        for n, d in log.launches:
            require(n in chunks[d] and n < max(slices.values()),
                    f"{name} rank {rank} step {step}: an SMW launch on {n} "
                    f"slices of {d}^2, not an owned chunk {chunks[d]}")
        gemm = "fused_precond[int8]" if quant else "fused_precond"
        require(delta.get(gemm, 0) == len(manifest),
                f"{name} rank {rank} step {step}: {gemm} {delta}")
        held["smw launches on owned chunks"] += len(log.launches)
        if quant:
            for key in ("factor_banks", "pending_banks"):
                for bank in s.get(key, {}).values():
                    require(not bank["l_ef"].any() and not bank["r_ef"].any(),
                            f"{name} rank {rank} step {step}: error "
                            "feedback not zero under dist")
        held["leaf fingerprints equal across ranks"] += require_replicas(
            torch, dev, {"params": p, "state": s}, f"{name} step {step}")
        if rank == 0 and hit:
            mark = build.count_mark()
            if kw.get("staleness"):
                state_in, pkw = tee.rec["pre"]
                want = opt_s.precompute(state_in, **pkw)
                got = tee.rec["update"][1]        # the dist tick's result
                keys = ("factor_banks", "pending_banks")
            else:
                grads, state_in, ukw = tee.rec["update"]
                _, want = opt_s.update(grads, state_in, **ukw)
                got, keys = s, ("factor_banks",)
            build.rewind_counts(mark)
            torch.cuda.synchronize()
            for key in keys:
                for b in hit:
                    bid = b.bucket_id
                    for k, w in want[key][bid].items():
                        g = got[key][bid][k]
                        tag = f"{name} step {step} {key}/{bid}/{k}"
                        if k.endswith("_ef"):
                            continue        # dist: zero; single: residual
                        if torch.equal(g, w):
                            held["gathered bank leaves torch.equal to the "
                                 "single-device step"] += 1
                            continue
                        require(not quant and g.dtype == torch.bfloat16,
                                f"{tag}: int8 codes or scales differ from "
                                "the single-device step's")
                        err, ratio = bf16_close(g, w)
                        print(f"{tag}: max_abs_err {err:.3e}, worst ratio "
                              f"to the bf16 bound {ratio:.3f} (tol 1)")
                        require(math.isfinite(ratio) and ratio <= 1.0,
                                f"{tag} differs from the single-device step")
                        held["gathered bank leaves within the bf16 "
                             "bound"] += 1
            del want, got
        tee.rec.clear()                 # the step's inputs go
        torch.cuda.empty_cache()        # the other rank shares the card
    counts = ops.launch_counts()
    require_path_kernels(name, counts, ops.gemm_core_counts(),
                         ops.fallback_counts())
    # after the last step: every leaf of both ranks, byte for byte
    for path, t in flat_paths({"params": p, "state": s}):
        a, b = _gather_bytes(torch, t)
        require(torch.equal(a, b), f"{name}: the ranks differ at "
                f"{'/'.join(map(str, path))} after step {steps - 1}")
        held["leaves torch.equal across ranks after the last step"] += 1
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[{name}] rank {rank}: losses {losses}; step ms "
          f"{[round(t, 3) for t in times]}; peak {peak:.3f} GiB; held "
          f"{dict(held)}", flush=True)
    return {"counts": counts, "held": dict(held), "losses": losses,
            "step_ms": times, "peak_gib": peak}


def dist_child(rank: int, store: str, out: str) -> int:
    """One rank of path o2 (``chip_smoke.py --dist-rank R --dist-store S
    --dist-out O``, started by :func:`dist_world2_path`): joins the gloo
    group, runs DIST_RUNS, writes its results to ``out`` as JSON."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             rank=rank, world_size=2)
    try:
        import dataclasses
        from repro_torch.configs import bert_large
        from repro_torch.kernels import ops
        setup = bert_large_setup(dev, dataclasses.replace(
            bert_large.CONFIG, n_layers=TWO_RANK_LAYERS))
        log = ChunkLog(ops)
        results = {}
        for name, (kw, steps) in DIST_RUNS.items():
            t0 = time.perf_counter()
            results[name] = dist_world2_run(torch, dev, setup, name, kw,
                                            steps, rank, log)
            results[name]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    Path(out).write_text(json.dumps(results))
    return 0


def _two_ranks(flag, tag, timeout):
    """This script re-run as two ranks on the one card (``flag R
    --dist-store S --dist-out O``), each rank's output to a file; rank 0's
    printed.  Returns both ranks' JSON results."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.json" for r in range(2)]
        # two processes share the card: segments that grow and shrink keep
        # one rank's cached blocks from starving the other
        env = dict(os.environ,
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        # each rank writes its output to a file: a rank never blocks on a
        # full pipe while the other waits for it in a collective
        logs = [Path(tmp) / f"rank{r}.log" for r in range(2)]
        procs = []
        try:
            for r in range(2):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         flag, str(r), "--dist-store",
                         str(Path(tmp) / "store"), "--dist-out",
                         str(outs[r])], stdout=f, stderr=subprocess.STDOUT,
                        text=True, env=env))
            deadline = time.monotonic() + timeout
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print(logs[0].read_text().rstrip())
        if any(proc.returncode for proc in procs):
            print(f"--- rank 1 (last lines)\n{logs[1].read_text()[-3000:]}")
        require(all(proc.returncode == 0 for proc in procs),
                f"{tag}: a rank failed (exit codes "
                f"{[proc.returncode for proc in procs]})")
        return [json.loads(o.read_text()) for o in outs]


def dist_world2_path(torch):
    """Path o2: two processes on the one card over gloo (the launcher's
    --dist --dist-backend gloo, eager), each running DIST_RUNS; rank 0's
    output is printed.  Returns the launch counts of both ranks."""
    launches = collections.Counter()
    res = _two_ranks("--dist-rank", "dist_w2", DIST_TIMEOUT)
    for name in DIST_RUNS:
        r0, r1 = res[0][name], res[1][name]
        require(r0["losses"] == r1["losses"], f"{name}: losses differ")
        for r in (r0, r1):
            launches.update(r["counts"])
        print(f"[{name}] two ranks on one card over gloo: losses "
              f"{r0['losses']}; step ms rank 0 "
              f"{[round(t, 3) for t in r0['step_ms']]} (median of steps 1-"
              f"{len(r0['step_ms']) - 1} "
              f"{statistics.median(r0['step_ms'][1:]):.3f}); peak memory "
              f"rank 0 {r0['peak_gib']:.3f} GiB (with the comparison "
              f"copies), rank 1 {r1['peak_gib']:.3f} GiB; launches rank 0 "
              f"{r0['counts']}, rank 1 {r1['counts']}; held: rank 0 "
              f"{r0['held']}, rank 1 {r1['held']}; {r0['seconds']:.1f} s")
        SUMMARY[name]["eager_ms"] = statistics.median(r0["step_ms"][1:])
        SUMMARY[name]["eager_peak"] = max(r0["peak_gib"], r1["peak_gib"])
    return launches


# ----------------------------------------------------------------------- #
# Path p: elastic fault tolerance (training/resilience.py, the launcher's
# --elastic)
# ----------------------------------------------------------------------- #
def _launch(argv, tag, sigterm_after=None):
    """``python -m repro_torch.launch.train argv`` in a process of its own
    (a session of its own: the ranks it spawns write to the same pipe and
    are stopped with it), every line printed with ``tag``.  With
    ``sigterm_after`` (a line prefix) the launcher gets SIGTERM as soon as
    such a line comes.  Returns (exit code, lines, seconds)."""
    import signal
    import threading
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT, start_new_session=True)

    def kill_group():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    timer = threading.Timer(ELASTIC_TIMEOUT, kill_group)
    timer.start()
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            print(f"[{tag}] {lines[-1]}", flush=True)
            if sigterm_after and not sent and \
                    lines[-1].startswith(sigterm_after):
                proc.send_signal(signal.SIGTERM)
                sent = True
                print(f"[{tag}] (SIGTERM sent to the launcher)", flush=True)
        rc = proc.wait()
    finally:
        timer.cancel()
        kill_group()                  # whatever the session left running
        proc.wait()
    seconds = time.perf_counter() - t0
    print(f"[{tag}] exit code {rc}, {seconds:.1f} s", flush=True)
    require(not sigterm_after or sent, f"{tag}: no line {sigterm_after!r}")
    return rc, lines, seconds


def _logged(path):
    """The launcher's --log-json history: [(step, loss)]."""
    return [(h["step"], h["loss"]) for h in json.loads(Path(path).read_text())]


def elastic_launcher_path():
    """p1 as a user runs it: ``launch/train.py --elastic --dist
    --dist-devices 1`` (one spawned NCCL rank) with ``--chaos
    drop_collective@4 --log-json``, its losses float for float the
    launcher's without --elastic and chaos, the retry line printed; then
    with ``--ckpt-dir`` (no chaos) and SIGTERM to the launcher as soon as
    its first chunk's lines come: exit 0, the preemption line, an
    emergency checkpoint whose cursor is the next unconsumed step; a rerun
    resumes there and ends on the uninterrupted run's final loss, bit for
    bit."""
    import tempfile
    from repro_torch import checkpointing
    from repro_torch.checkpointing import msgpack_codec
    base = ELASTIC_LAUNCH + ELASTIC_DIST
    steps = int(base[base.index("--steps") + 1])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rc, _, sec_plain = _launch(
            base + ["--log-json", str(tmp / "plain.json")], "elastic plain")
        require(rc == 0, f"elastic plain: exit code {rc}")
        want = _logged(tmp / "plain.json")
        rc, lines, sec_drop = _launch(
            base + ["--elastic", "--chaos", ELASTIC_DROP, "--log-json",
                    str(tmp / "drop.json")], "elastic drop")
        require(rc == 0, f"elastic drop: exit code {rc}")
        got = _logged(tmp / "drop.json")
        drop_at = int(ELASTIC_DROP.split("@")[1])
        retry = [ln for ln in lines if ln.startswith(
            f"[elastic] step {drop_at}: dispatch failed")]
        require(len(retry) == 1, f"elastic drop: retry lines {retry}")
        require(len(want) == steps and got == want,
                f"elastic drop: losses {got} against the plain launcher's "
                f"{want}")
        print(f"[elastic drop] {steps} losses float for float the launcher's "
              f"without --elastic: {[x for _, x in got]}; retry line: "
              f"{retry[0]}")
        ckpt = tmp / "ckpt"
        rc, lines, sec_pre = _launch(
            base + ["--elastic", "--ckpt-dir", str(ckpt), "--log-json",
                    str(tmp / "pre.json")], "elastic preempt",
            sigterm_after="step     2 loss=")
        require(rc == 0, f"elastic preempt: exit code {rc}")
        require("preempted: emergency checkpoint taken, exiting cleanly" in
                lines, "elastic preempt: no preemption line")
        logged = _logged(tmp / "pre.json")
        at = checkpointing.latest_step(str(ckpt))
        require(at is not None and checkpointing.validate(str(ckpt), at),
                "elastic preempt: no valid emergency checkpoint")
        meta = msgpack_codec.unpackb((ckpt / f"step_{at:08d}" /
                                      "manifest.msgpack").read_bytes())[
            "metadata"]
        cursor = meta["cursor"]["step"]
        require(meta.get("emergency") is True and
                cursor == logged[-1][0] + 1 < steps,
                f"elastic preempt: checkpoint metadata {meta} after logged "
                f"steps {[k for k, _ in logged]}")
        require(logged == want[:cursor], "elastic preempt: losses before the "
                "preemption differ from the uninterrupted run's")
        rc, lines, sec_res = _launch(
            base + ["--elastic", "--ckpt-dir", str(ckpt), "--log-json",
                    str(tmp / "resume.json")], "elastic resume")
        require(rc == 0, f"elastic resume: exit code {rc}")
        require(f"restored checkpoint step {cursor - 1} (data cursor "
                f"{cursor})" in lines, "elastic resume: no restore line")
        resumed = _logged(tmp / "resume.json")
        print(f"[elastic preempt] SIGTERM after the first chunk: stopped "
              f"after step {cursor - 1}, emergency checkpoint metadata "
              f"{meta}; the rerun logged {resumed}; the uninterrupted run "
              f"{want[cursor:]}")
        require(resumed == want[cursor:], "elastic resume: losses differ "
                "from the uninterrupted run's")
    SUMMARY["elastic_p1"].update(launch_s=(sec_plain, sec_drop, sec_pre,
                                           sec_res), cursor=cursor)


def elastic_turns(torch, dev):
    """p1's captured step with --elastic (the runner keeps its inputs: a
    copy of params and state into its buffers and a clone out, each chunk)
    against the launcher's step without it, both built by the launcher
    (``setup``'s ``make_runner``) without --dist: each runner's first two
    chunks alone (captures, then replays) with its peak memory, then in
    turns in this process (elastic, plain, plain, elastic), chunks of 3
    synchronized, the first of each turn dropped.  Returns the launches,
    the elastic run (``setup``'s result) and the params and state."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.training import loop as train_lib
    plain = train_cli.setup(train_cli.parse_args(ELASTIC_LAUNCH))
    el = train_cli.setup(train_cli.parse_args(ELASTIC_LAUNCH + ["--elastic"]))
    params, state, ds = plain.params, plain.opt_state, plain.ds
    el.params = el.opt_state = plain.params = plain.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    chunk = int(ELASTIC_LAUNCH[ELASTIC_LAUNCH.index("--chunk") + 1])
    runners = {"plain": plain.make_runner(), "elastic": el.make_runner()}
    require(runners["plain"].donate and not runners["elastic"].donate,
            "elastic turns: the launcher's runners donate wrongly")
    i, mem = 0, {}

    def run(kind):
        nonlocal params, state, i
        from repro_torch.data import pipeline
        stacked = train_lib.stack_batches(
            [pipeline.make_batch(ds, i + k) for k in range(chunk)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = runners[kind](params, state, stacked)
        torch.cuda.synchronize()              # the clones out, too
        i += chunk
        require(all(math.isfinite(float(x)) for x in m["loss"]),
                f"elastic turns: non-finite loss ({kind})")
        return (time.perf_counter() - t0) * 1e3 / chunk

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    for kind in ("plain", "elastic"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats()
        run(kind)
        run(kind)
        mem[kind] = (before / 2 ** 30,
                     torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                     torch.cuda.max_memory_reserved(dev) / 2 ** 30)
        print(f"[elastic turns] {kind}: a chunk of captures and one of "
              f"replays; allocated before {mem[kind][0]:.3f} GiB, peak "
              f"allocated {mem[kind][1]:.3f} GiB, peak reserved "
              f"{mem[kind][2]:.3f} GiB")
    medians = {"plain": [], "elastic": []}
    for kind in ("elastic", "plain", "plain", "elastic"):
        times = [run(kind) for _ in range(ELASTIC_TURN_CHUNKS)]
        medians[kind].append(statistics.median(times[1:]))
        print(f"[elastic turns] {kind}: ms a step over chunks of {chunk} "
              f"{[round(t, 3) for t in times]}, median of chunks 2-"
              f"{ELASTIC_TURN_CHUNKS} {medians[kind][-1]:.3f}")
    counts = ops.launch_counts()
    require_path_kernels("elastic_p1", counts, ops.gemm_core_counts(),
                         ops.fallback_counts())
    e, p = (statistics.median(medians[k]) for k in ("elastic", "plain"))
    print(f"[elastic turns] captured step {e:.3f} ms with --elastic against "
          f"{p:.3f} ms without ({e - p:+.3f} ms, {100 * (e / p - 1):+.1f} %)")
    SUMMARY["elastic_p1"].update(turn_elastic=e, turn_plain=p, mem=mem)
    for r in runners.values():
        r.release()
    del runners
    return counts, el, params, state


def elastic_rebuild_path(torch, dev, el, carried):
    """p3: the launcher's ``make_runner`` twice, as a remap rebuilds (at
    world 1 no kill or demotion changes the mask, so the supervisor cannot
    drive it on one card), at full bert-large rank 1: the first runner
    captures and replays a chunk, is released
    (``ChunkRunner.release``), and the second captures; the peak reserved
    memory after the second capture within the first runner's plus
    REBUILD_SLACK_GIB; then the second runner's replays, each against the
    eager step from the same state (:class:`ReplayCheck`).  ``carried``:
    a list holding the params and state, emptied here, so that only the
    runners' own results stay alive, as in a rebuild.  Returns the
    launches."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib
    chunk = int(ELASTIC_LAUNCH[ELASTIC_LAUNCH.index("--chunk") + 1])
    params, state = carried
    carried.clear()
    i = int(state["count"])

    def stacked():
        nonlocal i
        out = train_lib.stack_batches(
            [pipeline.make_batch(el.ds, i + k) for k in range(chunk)])
        i += chunk
        return out
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    base = torch.cuda.memory_reserved(dev) / 2 ** 30
    live = torch.cuda.memory_allocated(dev) / 2 ** 30
    first = el.make_runner(None)
    for _ in range(2):
        params, state, _ = first(params, state, stacked())
    torch.cuda.synchronize()
    r1 = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    first.release()
    del first
    freed = torch.cuda.memory_reserved(dev) / 2 ** 30
    live2 = torch.cuda.memory_allocated(dev) / 2 ** 30
    second = el.make_runner(None)
    params, state, _ = second(params, state, stacked())
    torch.cuda.synchronize()
    r2 = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    print(f"[elastic rebuild] {live:.3f} GiB allocated ({base:.3f} GiB "
          f"reserved) before; peak reserved {r1:.3f} GiB with the first "
          f"runner (captured, one chunk replayed); {live2:.3f} GiB allocated "
          f"({freed:.3f} GiB reserved) after its release; peak {r2:.3f} GiB "
          f"after the second runner's capture ({r2 - r1:+.3f} GiB, tol "
          f"{REBUILD_SLACK_GIB})")
    require(r2 <= r1 + REBUILD_SLACK_GIB, "elastic rebuild: the second "
            "capture holds the first runner's memory too")
    check = ReplayCheck(torch, second, second.step_fn, "elastic_rebuild",
                        True)
    for _ in range(2):
        params, state, _ = second(params, state, stacked())
    check.report()
    require(check.n == 2 * chunk and len(second.graphs) == chunk,
            f"elastic rebuild: {check.n} replays, {len(second.graphs)} "
            "graphs")
    counts = ops.launch_counts()
    require_path_kernels("elastic_p1", counts, ops.gemm_core_counts(),
                         ops.fallback_counts())
    del second._replay, check
    second.release()
    SUMMARY["elastic_p1"].update(rebuild=(r1, freed, r2))
    return counts


def elastic_kill_run(torch, dev, rank):
    """p2 in this rank (one of two gloo ranks on the one card): bert-large
    cut to TWO_RANK_LAYERS layers, ``resilience.elastic_train`` at
    --chunk 1 (eager runners without donation, built as the launcher's
    ``make_runner``, their optimizer wrapped by :class:`DistTee`), the
    sentinel, staleness 1, ELASTIC_KILL_CHAOS.  After each step: the SMW
    launches on the owned chunk (half the slices while both ranks live,
    all of them on the survivor after the kill) and the replicas'
    fingerprints.  At the remapped runner's first call: the reset buckets
    (trips up by one, cooldown armed) are ``orphaned_buckets`` on the old
    map, their active and pending banks the identity and windows zero, the
    quarantined state's fingerprints equal across the ranks.  At the step
    after the kill (rank 0): the tick's kernel launches and gathered banks
    torch.equal to the single-device kernel tick from the same quarantined
    state.  Returns the events, launches and what held."""
    import dataclasses
    from repro_torch.configs import bert_large
    from repro_torch.core import firstorder, stats as statlib
    from repro_torch.core.mkor import MKORConfig, manifest_for, mkor
    from repro_torch.kernels import build, ops
    from repro_torch.sharding import collectives
    from repro_torch.training import chaos, resilience
    from repro_torch.training import loop as train_lib
    from repro_torch.data import pipeline
    cfg = dataclasses.replace(bert_large.CONFIG,
                              n_layers=TWO_RANK_LAYERS)
    cfg, params, ds, _ = bert_large_setup(dev, cfg)
    dist = (("data", 2),)
    kw = dict(use_kernels=True, **ELASTIC_KILL_KW)
    mcfg = MKORConfig(dist=dist, **kw)
    opt_s = mkor(firstorder.lamb(1e-3), MKORConfig(**kw))
    manifest = manifest_for(params, mcfg)
    phases = statlib.bucket_phases(manifest, mcfg.inv_freq, mcfg.stagger)
    slices = {b.bucket_id: statlib.bucket_slices(b) for b in manifest}
    log = ChunkLog(ops)
    held = collections.Counter()
    per_step, last = [], {}
    tag = f"elastic_p2 rank {rank}"

    def eye_like(t):
        return torch.eye(t.shape[-1], dtype=t.dtype,
                         device=t.device).expand(t.shape)

    def check_quarantine(s, live):
        dead = [w for w, x in enumerate(live) if not x]
        want = resilience.orphaned_buckets(params, mcfg, dead, (True, True))
        before = last["state"]["health"]
        reset = [b.bucket_id for b in manifest
                 if int(s["health"][b.bucket_id]["trips"]) ==
                 int(before[b.bucket_id]["trips"]) + 1 and
                 int(s["health"][b.bucket_id]["cooldown"]) ==
                 mcfg.health_cooldown]
        require(reset == want and want, f"{tag}: reset buckets {reset}, "
                f"orphaned_buckets on the old map {want} (dead {dead})")
        for bid in want:
            for key in ("factor_banks", "pending_banks"):
                for k, t in s[key][bid].items():
                    require(torch.equal(t, eye_like(t)),
                            f"{tag}: {key}/{bid}/{k} is not the identity")
                    held["orphan bank leaves the identity"] += 1
            for k, t in s["stat_windows"][bid].items():
                require(not t.any(), f"{tag}: stat_windows/{bid}/{k} not 0")
                held["orphan window leaves zero"] += 1
        held["quarantined leaves equal across ranks"] += require_replicas(
            torch, dev, s, f"{tag} quarantined state")
        print(f"[{tag}] quarantined {want} (orphaned_buckets on the old map):"
              " banks the identity, windows zero, cooldown "
              f"{mcfg.health_cooldown}, equal across the ranks", flush=True)

    def compare_tick(tee):
        """The single-device kernel tick from the same quarantined state
        against the dist tick (rank 0)."""
        state_in, pkw = tee.rec["pre"]
        got_out, log.outputs = log.outputs, []
        mark = build.count_mark()
        log.keep = True
        want = opt_s.precompute(state_in, **pkw)
        log.keep = False
        build.rewind_counts(mark)
        want_out, log.outputs = log.outputs, []
        torch.cuda.synchronize()
        require(len(got_out) == len(want_out) > 0,
                f"{tag}: {len(got_out)} tick launches, single-device "
                f"{len(want_out)}")
        for g, w in zip(got_out, want_out):
            g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
            for a, b in zip(g, w):
                # the dist launch takes the owned chunk's lead dims flat
                require(a.numel() == b.numel() and torch.equal(
                    a.reshape(-1), b.reshape(-1)), f"{tag}: a tick launch's "
                    "result differs from the single-device kernel's")
                held["tick launch results torch.equal to the single-device "
                     "kernel's"] += 1
        got = tee.rec["update"][1]
        for key in ("factor_banks", "pending_banks"):
            for bid, bank in want[key].items():
                for k, w in bank.items():
                    require(torch.equal(got[key][bid][k], w),
                            f"{tag}: {key}/{bid}/{k} differs from the "
                            "single-device kernel tick")
                    held["gathered bank leaves torch.equal to the "
                         "single-device tick"] += 1

    def factory(live):
        tee = DistTee(mkor(firstorder.lamb(1e-3), MKORConfig(
            dist=dist, live=live, **kw)))
        inner = train_lib.make_chunk_runner(
            train_lib.make_dist_train_step(cfg, tee.opt, dist),
            donate=False, capture=False)
        n_live = sum(live) if live is not None else 2
        first = [live is not None]

        def run(p, s, stacked):
            step = int(s["count"])
            if first[0]:
                first[0] = False
                check_quarantine(s, live)
            before = ops.launch_counts()
            log.launches.clear()
            log.keep = rank == 0 and step == ELASTIC_KILL_AT
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = inner(p, s, stacked)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            log.keep = False
            now = ops.launch_counts()
            delta = {k: now.get(k, 0) - before.get(k, 0) for k in now}
            hit = [b for b in manifest
                   if step % mcfg.inv_freq == phases[b.bucket_id]]
            require(delta.get("fused_block_smw", 0) == 2 * len(hit) ==
                    len(log.launches), f"{tag} step {step}: {delta} with "
                    f"{len(hit)} phase buckets")
            owned = {}
            for b in manifest:
                for d in (b.d_in, b.d_out):
                    owned.setdefault(d, set()).add(collectives.owner_chunk(
                        slices[b.bucket_id], n_live))
            for n, d in log.launches:
                require(n in owned[d], f"{tag} step {step}: an SMW launch "
                        f"on {n} slices of {d}^2, not an owned chunk "
                        f"{owned[d]} of {n_live} live")
            per_step.append((step, list(live or (True, True)),
                             list(log.launches), round(ms, 3)))
            print(f"[{tag}] step {step} (live {live or (True, True)}): "
                  f"loss {float(m['loss'][0]):.6f}, SMW launches (slices, "
                  f"d) {log.launches}, {ms:.1f} ms", flush=True)
            if step == ELASTIC_KILL_AT and rank == 0:
                require(live is not None and hit, f"{tag}: the step after "
                        "the kill runs no tick")
                compare_tick(tee)
            tee.rec.clear()
            held["leaf fingerprints equal across ranks"] += require_replicas(
                torch, dev, {"params": p, "state": s}, f"{tag} step {step}")
            last["state"] = s
            return p, s, m
        return run

    sup = resilience.ElasticSupervisor(
        2, echo=lambda line: print(f"[{tag}] {line}", flush=True))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    t0 = time.perf_counter()
    state = mkor(firstorder.lamb(1e-3), mcfg).init(params)
    p, s, hist, preempted = resilience.elastic_train(
        factory, params, state,
        make_batch=lambda i: pipeline.make_batch(ds, i),
        stack_batches=train_lib.stack_batches, start=0,
        steps=ELASTIC_KILL_STEPS, chunk=1, supervisor=sup,
        plan=chaos.parse_chaos_spec(ELASTIC_KILL_CHAOS), mcfg=mcfg)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    require_path_kernels("elastic_p2", counts, ops.gemm_core_counts(),
                         ops.fallback_counts())
    require(not preempted and len(hist) == ELASTIC_KILL_STEPS and
            all(math.isfinite(h["loss"]) for h in hist),
            f"{tag}: history {hist}")
    for path, t in flat_paths({"params": p, "state": s}):
        a, b = _gather_bytes(torch, t)
        require(torch.equal(a, b), f"{tag}: the ranks differ at "
                f"{'/'.join(map(str, path))} after the last step")
        held["leaves torch.equal across ranks after the last step"] += 1
    return {"events": [{**e, "mask": list(e["mask"])} for e in sup.events],
            "counts": counts, "held": dict(held), "steps": per_step,
            "losses": [h["loss"] for h in hist], "seconds": seconds,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def elastic_child(rank: int, store: str, out: str) -> int:
    """One rank of path p2 (``chip_smoke.py --elastic-rank R --dist-store
    S --dist-out O``, started by :func:`elastic_kill_path`)."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             rank=rank, world_size=2)
    try:
        result = elastic_kill_run(torch, dev, rank)
    finally:
        tdist.destroy_process_group()
    Path(out).write_text(json.dumps(result))
    return 0


def elastic_kill_path(torch):
    """p2: two processes on the one card over gloo (NCCL refuses two ranks
    on one card), each running :func:`elastic_kill_run`; both ranks'
    supervisor events and losses equal.  Returns both ranks' launches."""
    res = _two_ranks("--elastic-rank", "elastic_p2", ELASTIC_TIMEOUT)
    r0, r1 = res
    require(r0["events"] == r1["events"] and r0["events"],
            f"elastic_p2: events differ: {r0['events']} against "
            f"{r1['events']}")
    require(r0["losses"] == r1["losses"], "elastic_p2: losses differ")
    launches = collections.Counter()
    for r in res:
        launches.update(r["counts"])
    print(f"[elastic_p2] two ranks through {ELASTIC_KILL_CHAOS}: events on "
          f"both ranks {r0['events']}; losses {r0['losses']}; SMW launches "
          f"(slices, d) a step, rank 0 "
          f"{[(st, lv, ln) for st, lv, ln, _ in r0['steps']]}, rank 1 "
          f"{[(st, lv, ln) for st, lv, ln, _ in r1['steps']]}; step ms rank "
          f"0 {[ms for *_, ms in r0['steps']]}; peak memory rank 0 "
          f"{r0['peak_gib']:.3f} GiB, rank 1 {r1['peak_gib']:.3f} GiB; "
          f"launches rank 0 {r0['counts']}, rank 1 {r1['counts']}; held: "
          f"rank 0 {r0['held']}, rank 1 {r1['held']}; {r0['seconds']:.1f} s")
    SUMMARY["elastic_p2"]["eager_ms"] = statistics.median(
        ms for *_, ms in r0["steps"][1:])
    SUMMARY["elastic_p2"]["eager_peak"] = max(r0["peak_gib"], r1["peak_gib"])
    return launches


def elastic_path(torch, dev):
    """Path p: p1 (the launcher; its captured step with and without
    --elastic, in turns), p3 (the rebuild), p2 (a kill on the card), each
    sub-path's seconds printed.  Returns the launches."""
    launches = collections.Counter()
    t0 = time.perf_counter()
    elastic_launcher_path()
    print(f"[elastic p1 launcher] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, el, params, state = elastic_turns(torch, dev)
    launches.update(counts)
    print(f"[elastic p1 turns] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    carried = [params, state]
    del params, state
    launches.update(elastic_rebuild_path(torch, dev, el, carried))
    del el
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[elastic p3 rebuild] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(elastic_kill_path(torch))
    print(f"[elastic p2 kill] done in {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------- #
# Path q: the model zoo at full width
# ----------------------------------------------------------------------- #
def zoo_config(name):
    """``name``'s config at full width, cut in depth as ZOO_CUTS says."""
    import dataclasses
    from repro_torch.configs import registry
    cfg, cut = registry.get_config(name), ZOO_CUTS[name]
    if "reduced" in cut:
        return cfg.reduced(n_layers=cut["reduced"])
    return dataclasses.replace(cfg, **cut) if cut else cfg


def zoo_setup(dev, name):
    """The config, random weights from seed 0, its synthetic data (batch 8
    x 128 text tokens, after a VLM's patch prefix), a maker of host
    batches (with an encoder-decoder model's frames, as the launcher makes
    them) and a maker of mkor optimizers (over ZOO_BACKEND's) and their
    steps."""
    from repro_torch.core import firstorder
    from repro_torch.core.mkor import MKORConfig, mkor
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.training import loop as train_lib

    cfg = zoo_config(name)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    ds = pipeline.make_dataset(
        cfg, global_batch=ZOO_BATCH,
        seq_len=ZOO_TEXT + train_lib.text_prefix_len(cfg), seed=0)
    print(f"{cfg.name}: {model_lib.param_count(params):,} params, "
          f"{cfg.n_layers} layers ({cfg.n_repeats} x "
          f"{[f'{p.kind}/{p.mlp}' for p in cfg.pattern]}), d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}, cut {ZOO_CUTS[name] or 'none'}, mkor("
          f"{ZOO_BACKEND.get(name, 'lamb')})")

    def host_batch(step):
        batch = pipeline.make_batch(ds, step)
        if cfg.is_encoder_decoder:
            batch["frontend_embeds"] = pipeline.encoder_frames(
                cfg, ZOO_BATCH, step)
        return batch

    backend = {"lamb": firstorder.lamb,
               "sgd": firstorder.sgd}[ZOO_BACKEND.get(name, "lamb")]

    def make(use_kernels, **kw):
        kw.setdefault("inv_freq", 3)
        mcfg = MKORConfig(use_kernels=use_kernels, **kw)
        opt = mkor(backend(1e-3), mcfg)
        return opt, train_lib.make_train_step(cfg, opt), mcfg
    return cfg, params, ds, host_batch, make


def zoo_buckets(params, mcfg):
    """The bucket manifest's PATH_KERNELS row ("zoo_extra" when every
    bucket has extra dims), and the per-step fallbacks it implies: one
    extra-dims route a step for each bucket with extra dims."""
    from repro_torch.core.mkor import manifest_for
    manifest = manifest_for(params, mcfg)
    n_extra = sum(1 for b in manifest if b.extra)
    print(f"{len(manifest)} buckets, {n_extra} with extra dims: " + ", ".join(
        f"{b.bucket_id} x{b.n_slots}" for b in manifest))
    row = "zoo_extra" if n_extra == len(manifest) else "zoo"
    return row, {("fused_precond", "extra_dims"): n_extra}


def zoo_step0(torch, dev, tag, cfg, params, batch0, make):
    """Step 0 from the same state through the plain route and the kernels
    (no stagger: every bucket inverts, every bank side goes through
    fused_smw): banks in the bf16 bound, the parameter update and the loss
    after the step as check_step0 holds them.  The plain route runs first;
    its loss after the step is taken at once, and its banks and params
    wait on the host, so that the card never holds two optimizer states.
    Returns the kernel route's (params, state, metrics) and its optimizer
    and step."""
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_leaves, tree_map

    def to_host(tree):
        return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
    loss_fn = train_lib.make_loss_fn(cfg, collect_stats=False)
    opt_p, step_p, _ = make(False, stagger=False)
    pp, sp, _ = step_p(params, opt_p.init(params), batch0)
    with torch.no_grad():
        lp = float(loss_fn(pp, batch0)[0])
    banks_p, pp = to_host(sp["factor_banks"]), to_host(pp)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    opt_k, step_k, _ = make(True, stagger=False)
    pk, sk, mk = step_k(params, opt_k.init(params), batch0)
    with torch.no_grad():
        lk = float(loss_fn(pk, batch0)[0])
    compare_banks(f"[{tag}] step 0", sk["factor_banks"],
                  tree_map(lambda t: t.to(dev), banks_p))
    del banks_p
    num = den = 0.0
    for a, b, c in zip(tree_leaves(pk), tree_leaves(pp), tree_leaves(params)):
        dk, dp = a.float() - c.float(), b.to(dev).float() - c.float()
        num += float(torch.sum(torch.square(dk - dp)))
        den += float(torch.sum(torch.square(dp)))
        del dk, dp
    del pp
    rel = math.sqrt(num / max(den, 1e-30))
    print(f"[{tag}] step 0 param update vs plain: relative Frobenius error "
          f"{rel:.3e} (tol 2e-2)")
    require(rel <= 2e-2, f"{tag}: step 0 parameter update differs")
    l0 = float(mk["loss"])
    # 5 % of what the step did to the loss, plus 1e-5 relative for bf16
    # parameters that round the other way (check_step0)
    tol = 0.05 * abs(lp - l0) + 1e-5 * abs(lp)
    print(f"[{tag}] step 0 loss {l0:.6f}; after the step: kernels "
          f"{lk:.6f}, plain {lp:.6f} (|diff| {abs(lk - lp):.3e}, tol "
          f"{tol:.3e})")
    require(math.isfinite(l0) and math.isfinite(lk) and
            abs(lk - lp) <= tol, f"{tag}: loss after step 0 differs")
    return (pk, sk, mk), opt_k, step_k


def zoo_fingerprints(torch, tree):
    return {"/".join(map(str, k)): fingerprint(torch, v)
            for k, v in flat_paths(tree)}


def zoo_repeat(torch, tag, step_fn, params, state, batch):
    """The step twice from one state (the step is functional: its inputs
    stay as they were), each result's every leaf fingerprinted
    (:func:`fingerprint`); the two must agree leaf for leaf.  Returns the
    second run's (params, state, metrics)."""
    outs = []
    for _ in range(2):
        out = step_fn(params, state, batch)
        outs.append(zoo_fingerprints(torch, {
            "params": out[0], "state": out[1],
            "metrics": {k: v.float() for k, v in out[2].items()}}))
        if len(outs) == 1:
            del out
            gc.collect()
    apart = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    print(f"[{tag}] the step twice from one state: {len(apart)} of "
          f"{len(outs[0])} leaves apart" + (f" ({', '.join(apart[:6])})"
                                              if apart else ""))
    require(not apart, f"{tag}: the step run twice gave other bits")
    return out


def zoo_q1(torch, dev):
    """q1: qwen2-moe-a2.7b at full width, 2 layers: step 0 against the
    plain route, 6 eager steps (launches, the expert buckets' counted
    extra-dims fallbacks), the step twice from one state, a profiled step
    with phase times, then captured through the chunk runner (each replay
    against the eager step), replays alone.  Returns the launch counts."""
    name = "qwen2_moe"
    cfg, params, ds, host_batch, make = zoo_setup(dev, ZOO_Q1)
    from repro_torch.training import loop as train_lib
    batch0 = train_lib.batch_to_device(host_batch(0), dev)
    t0 = time.perf_counter()
    zoo_step0(torch, dev, name, cfg, params, batch0, make)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{name}] step 0 checked in {time.perf_counter() - t0:.1f} s")
    opt_k, step_k, mcfg = make(True)
    row, per_step = zoo_buckets(params, mcfg)
    require(row == "zoo", f"{name}: every bucket has extra dims")
    params, state, counts = run_path(torch, dev, name, step_k, opt_k,
                                     params, ds, ZOO_STEPS,
                                     fallbacks_per_step=per_step)
    batch = train_lib.batch_to_device(host_batch(ZOO_STEPS), dev)
    zoo_repeat(torch, name, step_k, params, state, batch)
    del batch
    profile_and_phases(torch, dev, cfg, ds, step_k, opt_k, params, state,
                       ZOO_STEPS, name)
    gc.collect()
    torch.cuda.empty_cache()
    g_counts, params, state, runner = zoo_graph(
        torch, dev, name, step_k, params, state, ds, ZOO_STEPS,
        mcfg.inv_freq)
    del params, state, runner, step_k
    gc.collect()
    torch.cuda.empty_cache()
    launches = collections.Counter(counts)
    launches.update(g_counts)
    return launches


def zoo_graph(torch, dev, name, step_fn, params, state, ds, start, n_keys):
    """q1 captured through the chunk runner from the eager run's final
    state (count ``start``), 3 x ``n_keys`` steps in chunks of ``n_keys``:
    each residue's first step runs eagerly before its capture, and its
    graph then replays twice.  The card does not hold a second copy of the
    state beside the graph pool, so each replay is held against its eager
    step by fingerprints (:func:`fingerprint`, every leaf of params, state
    and metrics): the eager run of the same steps from the same state goes
    first (the state kept on the host meanwhile), and every replay's
    result must equal the eager step's of its count leaf for leaf (the
    eager step is deterministic: ``zoo_repeat``).  Launch counts set to 0
    just before the runner, read just after; then replays alone.  Returns
    (counts, params, state, runner)."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.training import loop as train_lib
    from repro_torch.tree import tree_map
    gname = f"{name}[graph]"
    steps = 3 * n_keys
    batches = [pipeline.make_batch(ds, start + i) for i in range(steps)]
    devs = tree_map(lambda t: t.device, (params, state))
    kept = tree_map(lambda t: t.detach().to("cpu", copy=True),
                    (params, state))
    want = {}
    mark = build.count_mark()
    for i, b in enumerate(batches):
        params, state, m = step_fn(params, state,
                                   train_lib.batch_to_device(b, dev))
        want[start + i + 1] = zoo_fingerprints(torch, {
            "params": params, "state": state,
            "metrics": {k: v.float() for k, v in m.items()}})
    build.rewind_counts(mark)
    del params, state, m
    gc.collect()
    torch.cuda.empty_cache()
    params, state = tree_map(lambda t, d: t.to(d), kept, devs)
    del kept
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    runner = train_lib.make_chunk_runner(step_fn)
    replay, checked = runner._replay, []

    def checked_replay(graph):
        replay(graph)
        p, s = runner._tree_at([h + d for h, d in zip(runner.host,
                                                         graph.delta)])
        got = zoo_fingerprints(torch, {
            "params": p, "state": s,
            "metrics": dict(zip(runner._keys, runner._metrics))})
        ref = want[int(s["count"])]
        apart = [k for k in ref if not torch.equal(ref[k], got[k])]
        require(sorted(ref) == sorted(got) and not apart,
                f"{gname}: the replay at count {int(s['count'])} differs "
                f"from the eager step at {apart[:6]}")
        checked.append(int(s["count"]))
    runner._replay = checked_replay
    params, state, hist = train_lib.train_epoch(
        step_fn, params, state, batches, chunk=n_keys, runner=runner)
    counts, cores = ops.launch_counts(), ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    losses = [h["loss"] for h in hist]
    print(f"[{gname}] train losses {losses}")
    require(all(math.isfinite(x) for x in losses),
            f"{gname}: non-finite loss")
    require(len(runner.graphs) == n_keys and len(checked) == steps - n_keys,
            f"{gname}: {len(runner.graphs)} graphs, {len(checked)} replays")
    print(f"[{gname}] {len(checked)} replays at counts {checked}, each "
          f"equal leaf for leaf ({len(want[checked[0]])} leaves) to the "
          f"eager step of its count; {len(runner.graphs)} graphs; launch "
          f"counts {counts}, GEMM cores {cores}, fallbacks {fallbacks}")
    must, must_not = PATH_KERNELS[name]
    for k in must:
        require(counts.get(k, 0) > 0, f"{gname}: {k} was not launched")
    for k in must_not:
        require(counts.get(k, 0) == 0, f"{gname}: {k} was launched")
    require_fallbacks(name, fallbacks)
    del runner._replay
    params, state = replays_alone(torch, dev, name, runner, params, state,
                                  ds, start + steps, n_keys)
    return counts, params, state, runner


def zoo_q2(torch, dev, name):
    """q2: one assigned config at full width, cut in depth (ZOO_CUTS): step
    0 against the plain route, then step 1 twice from one state; launches,
    fallbacks (counted: one a step for each bucket with extra dims, over
    the three kernel steps), losses and peak memory.  Returns the launch
    counts."""
    from repro_torch.kernels import ops
    from repro_torch.training import loop as train_lib
    tag = f"zoo {name}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, _, host_batch, make = zoo_setup(dev, name)
    row, per_step = zoo_buckets(params, make(True)[2])
    ops.reset_launch_counts()
    ops.reset_fallback_counts()
    (p1, s1, m0), opt_k, step_k = zoo_step0(
        torch, dev, tag, cfg, params,
        train_lib.batch_to_device(host_batch(0), dev), make)
    del params
    gc.collect()
    batch1 = train_lib.batch_to_device(host_batch(1), dev)
    _, _, m1 = zoo_repeat(torch, tag, step_k, p1, s1, batch1)
    losses = [float(m0["loss"]), float(m1["loss"])]
    counts, cores = ops.launch_counts(), ops.gemm_core_counts()
    fallbacks = ops.fallback_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[{tag}] losses {losses}, moe_aux "
          f"{[float(m0['moe_aux']), float(m1['moe_aux'])]}, peak memory "
          f"{peak:.3f} GiB, {time.perf_counter() - t0:.1f} s")
    require(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    require_path_kernels(row, counts, cores, fallbacks,
                         {k: 3 * v for k, v in per_step.items()})
    SUMMARY[f"zoo {name}"] = {"losses": losses, "peak": peak,
                              "fallbacks": dict(fallbacks),
                              "seconds": time.perf_counter() - t0}
    del p1, s1, m0, m1, batch1
    gc.collect()
    torch.cuda.empty_cache()
    return collections.Counter(counts)


def zoo_path(torch, dev):
    """Path q: q1, then q2 over the other assigned configs."""
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    launches = zoo_q1(torch, dev)
    print(f"[q1] path done in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    for name in registry.ASSIGNED:
        if name != ZOO_Q1:
            launches.update(zoo_q2(torch, dev, name))
    print(f"[q2] path done in {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_paths(torch, dev, setup):
    """Phases 4 and 5: path q (the model zoo), then each bert-large path's
    eager run and its captured version from the eager run's final state
    (its count, and the residues of its inv_freq); rank 1 and LAMB alone
    also in turns.  Returns the launch counts summed over the paths."""
    paths = {"rank1": (train_rank1, TRAIN_STEPS, 3),
             "rank4": (train_rank4, RANK4_STEPS, 4),
             "staleness1": (train_staleness1, STALE_STEPS, 3),
             "int8_rank1": (train_int8_rank1, TRAIN_STEPS, 3),
             "int8_rank4": (train_int8_rank4, RANK4_STEPS, 4),
             "int8_staleness1": (train_int8_staleness1, STALE_STEPS, 3),
             "lamb": (train_lamb, LAMB_STEPS, 1)}
    # path q first, on an empty card: q1's captured step needs the card
    # but for the graph pool and one state
    t0 = time.perf_counter()
    launches = zoo_path(torch, dev)
    print(f"[zoo] path done in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB still "
          "allocated")
    eager = {}
    for name, (fn, start, n_keys) in paths.items():
        t0 = time.perf_counter()
        counts, (step_fn, params, state) = fn(torch, dev, setup)
        eager[name] = counts
        torch.cuda.empty_cache()
        print(f"[{name}] path done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        g_counts, params, state, runner = graph_path(
            torch, dev, name, step_fn, params, state, setup[2], start,
            n_keys)
        if name in ("rank1", "lamb"):
            turns(torch, dev, name, step_fn, runner, params, state,
                  setup[2], int(state["count"]))
        del params, state, runner, step_fn
        gc.collect()                       # the graphs and their pool go
        torch.cuda.empty_cache()
        print(f"[{name}[graph]] path done in {time.perf_counter() - t0:.1f} "
              "s")
        for k, c in list(counts.items()) + list(g_counts.items()):
            launches[k] += c
    launches.update(mkor_h_path(torch, dev, setup))
    for name in HEALTH_SPECS:
        launches.update(health_path(torch, dev, setup, name))
    t0 = time.perf_counter()
    counts, (step_fn, params, state) = train_per_layer_rank1(
        torch, dev, setup, eager["rank1"])
    g_counts, params, state, runner = graph_path(
        torch, dev, "per_layer_rank1", step_fn, params, state, setup[2],
        PER_LAYER_STEPS, 3)
    launches.update(counts)
    launches.update(g_counts)
    del params, state, runner, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[per_layer_rank1] path done in {time.perf_counter() - t0:.1f} s")
    for name, fn in (("per_layer_rank4_stale1", train_per_layer_rank4_stale1),
                     ("eva", eva_path)):
        t0 = time.perf_counter()
        launches.update(fn(torch, dev, setup))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{name}] path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(baselines_path(torch, dev))
    print(f"[baselines] path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(dist_world1_path(torch, dev, setup))
    print(f"[dist_w1] path done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_launcher_path(torch)
    print(f"[dist_launcher] path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(dist_world2_path(torch))
    print(f"[dist_w2] path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(elastic_path(torch, dev))
    print(f"[elastic] path done in {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per = build.build()
    print(f"built {sorted(build.KERNEL_SOURCES)} from src/repro_torch/csrc "
          f"in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in per.items())})")

    rows = {name: KernelRow(name) for name in REPLACES}
    check_fused_smw(torch, rows)
    check_fused_precond(torch, rows)
    check_matmul(torch, rows)
    check_fused_block_smw(torch, rows)
    check_solve_mid(torch)
    check_matvec_and_rank1_update(torch, rows)
    check_fused_smw_int8(torch, rows)
    check_fused_block_smw_int8(torch, rows)
    check_fused_precond_int8(torch, rows)
    check_matmul_int8(torch, rows)
    check_poisoned_kernels(torch)
    check_non_pd_pivot(torch)
    check_owned_chunks(torch)
    t0 = time.perf_counter()
    check_zoo_dims(torch, rows)
    print(f"kernels at the zoo's dims checked in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in GEMM_KERNELS:
        r = rows[name]
        b_ms, b_by = r.bound(r.bytes, r.ops)
        if name in ATOMICS_MS:
            print(f"{name}, sum of the bert-large shapes, sums in a fixed "
                  f"order: {r.ms:.4f} ms against {ATOMICS_MS[name]:.3f} ms "
                  f"with atomic sums ({100 * (r.ms / ATOMICS_MS[name] - 1):+.1f}"
                  " %; another call, PERF.md)")
        print(f"{name}, sum of the bert-large shapes: wgmma core {r.ms:.4f} ms "
              f"{rate(r.ops, r.ms)}, " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in r.other_ms.items())
              + (f", library {r.library_ms:.4f} ms" if r.library_ms else "")
              + f", plain {r.plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    for name in SMW_KERNELS:
        r = rows[name]
        b_ms, b_by = r.bound(r.bytes, r.ops)
        print(f"{name}, sum of the bert-large shapes: {r.ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {stream_rate(r.bytes, r.ms, b_ms)}"
              + "".join(f", {k} {v:.4f} ms" for k, v in r.other_ms.items())
              + f", plain {r.plain_ms:.4f} ms")
    for name, (lib, _) in UNFUSED.items():
        r = rows[name]
        b_ms, b_by = r.bound(r.bytes, r.ops)
        dev = {k: r.other_ms[f"device {k}"] for k in DeviceTimer.STATES}
        lib_dev = {k: r.other_ms[f"{lib} device {k}"]
                   for k in DeviceTimer.STATES}
        verdict = "no slower than" if dev["cold"] <= lib_dev["cold"] else \
            "slower than"
        print(f"{name}, sum of d = 1024, 4096, 1001: device "
              f"{_device_line(dev)}, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / dev['cold']:.1f} % of it cold; {lib} device "
              f"{_device_line(lib_dev)}; call {r.ms:.4f} ms, {lib} call "
              f"{r.library_ms:.4f} ms, plain {r.plain_ms:.4f} ms; by cold "
              f"device time {verdict} {lib}")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()

    launches = train_paths(torch, torch.device("cuda"),
                           bert_large_setup(torch.device("cuda")))
    summary_lines()
    print(json.dumps({"kernels": [rows[n].as_json(launches.get(n, 0))
                                  for n in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) > 1 and sys.argv[1] == "--dist-rank":
            # one rank of path o2, started by dist_world2_path
            sys.exit(dist_child(int(sys.argv[2]), sys.argv[4], sys.argv[6]))
        if len(sys.argv) > 1 and sys.argv[1] == "--elastic-rank":
            # one rank of path p2, started by elastic_kill_path
            sys.exit(elastic_child(int(sys.argv[2]), sys.argv[4],
                                   sys.argv[6]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
