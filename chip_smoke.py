"""Run the PyTorch port's main paths once on a CUDA card, and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and scipy; builds everything from this checkout
into build/ (the CUDA kernels, one nvcc per source, all at once, beside
the native graph builder's g++). Phases, on one SIFT1M-shaped synthetic
set (1M x 128, 10,000 queries, L2, seed 7), generated once:

  1. device: the card's name and power limit; the fp32 precision lock;
  2. build: compile and load the kernel library and the native builder;
     then phase 5's native graph builds in the background on all cores but
     one, beside nvcc and phases 3-4, 7, 14-17, 20 and 21, which run before
     phase 5 (their QPS and build seconds share the host with it); the
     checks on the CPU twins (phases 8, 15's and 20's) and phase 18 wait
     until after phase 6, when the host is free again, and phase 12's set
     is made in the background from then on;
  3. K1's gather_score against its plain twin on the HNSW slice's shapes
     (B=4096 queries, K=256 candidate lanes, d=128, N=1M rows) for f32,
     bf16 and int8 rows under L2 and IP, ~10% masked lanes;
  4. K2 against its plain twins: the four class-max forms on the packed
     table (1,003,520 x 144 bf16) of the set, B=4096, L2 and IP, at the
     (cls, kb) that each FastFlatIndex route of phase 7 resolves to, and
     at cls=2048/kb=64 and cls=1024/kb=32; each fused select against the
     unfused form plus select_lanes, bit for bit; CUDA-event timings of
     kernels, twins and the bare bf16 product (torch.matmul, the
     yardstick the port never calls);
  5. HNSW: the native build at M=16, ef_construction=200, search with
     k=10, ef=96, frontier=8 at batch 4096 on f32 rows, then bf16 rows,
     after a warm-up pass, every layer-0 step one launch of K1's fused
     beam_step; recall@10 against an exact fp32 brute force on the card;
     5b. the native host search (graph/soa.py:host_search, the reference's
     knn) on the first 2,000 queries at ef=96 and ef=128 against the
     served path at the same ef (frontier=8): the overlap of their top-10s
     (>= 0.95 at ef=128) and each side's recall@10;
     5c. the builds' seeded draws (ops/threefry.py, JAX's) on the card and
     on the CPU, bit for bit: permutation at 1,000,000 and 2,700,000 (three
     sort rounds), choice of 100,000 of 1,000,000, randint of the routed
     build's 2,097,152 training ids at 100,663,296 rows;
  6. HNSW end to end: 256 queries on the CPU (twins) and the card;
  7. FastFlatIndex: all queries at batch 4096 through each of the four
     scan routes (the auto knobs, bench's keep2 point, keep2 at kb=64,
     kb=16), recall@10 against the same ground truth, QPS after a
     warm-up batch, each kernel's launches;
  8. FastFlatIndex end to end: 256 queries on the CPU and the card, at
     the auto knobs and the keep2 point;
     A profile of one auto batch (device time by kernel, busy share)
     follows phases 7 and 10;
  9. K3 against its plain twins: both split functions, keep1 and keep2, on
     the set's bf16 and int8 split tables (1,015,808 x 128, aux
     (2, 1,015,808)), B=4096, L2 and IP, at the (cls, kb) that each
     SplitFlatIndex route of phase 10 resolves to and at cls=4096/kb=32;
     each fused form against the unfused form plus select_lanes, bit for
     bit; CUDA-event timings of kernels, twins and the bare bf16 product
     (for int8, on the table widened to bf16 before the timing);
 10. SplitFlatIndex, bf16 and int8: all queries at batch 4096 through four
     routes (the auto knobs, keep2 at kb=32, keep2 at kb=64, kb=16),
     recall@10, QPS after a warm-up batch, each K3 form's launches;
 11. SplitFlatIndex end to end: 256 queries on the CPU and the card at the
     auto knobs, bf16 and int8.

Phase 19 runs between phases 5 and 6, on phase 5's graph:

 19. K1's beam_step against beam_step_ref, bit for bit after every step of
     whole searches of 512 queries, for f32, bf16 and int8 rows; one
     mid-search step at B=4096 timed with CUDA events for each row type,
     with the share of lanes that hold an id and the share of those kept
     after the duplicate drop, and the step's bound; a profile of one f32
     batch; the descent entry (entry_mode="descent"), whose greedy walk
     and first distance score through gather_score, served once.

Phases 14-18 (run between phases 8 and 9, on the same set) port the
scan-speed graph build and the block-max scans:

 14. K5 and K6 against their plain twins on FastFlat's packed table
     (1,003,520 x 144, 3,520 pad rows), B=4096, L2 and IP: bit for bit on
     an integer table of that shape (ties inside and across blocks), to a
     stated tolerance on the set's rows; CUDA-event timings of the kernels,
     the twins and the bare bf16 product;
 15. FastFlatIndex through the block-max route (K5, what the JAX package
     runs under interpret): all queries at batch 4096 and the auto kb,
     recall@10, QPS after a warm-up batch, K5's launches; then 256 queries
     on the CPU (twins) and the card;
 16. fast_build_graph on the card, the rows resident (M=16): pool 0 (k=32,
     keep2 at cls=1024, K2b) and pool 200 (ef_construction parity), each
     build's stage times, sweep plan and launches, each graph served as in
     phase 5 (f32 rows) beside the native graph;
 17. the same build through the block-max sweep (K5), its recall within
     0.01 of the pool-0 graph's;
 18. the build at 8192 x 16 on the CPU (twins) and on the card: equal levels
     and entry point, overlapping layer-0 lists, the same recall.

Phases 20 and 21 (run after phase 18 and before phase 5, beside the native
build, on the same set; phase 20's recall is held to phase 5's once that
is read) port the insert build and the online index:

 20. device_build_graph on the card at its defaults (batch 512, first
     batch 32, level cap 12) and M=16, ef_construction=200: the wall and
     CUDA-synchronised seconds of each stage of its rounds (the descent,
     the upper-level searches, the layer-0 search, the select, the own
     rows, the reverse edges, the re-prune), its rounds, inserts/s and
     beam_step and gather_score launches; its graph validated and served as
     in phase 5 (f32 rows), recall@10 within 0.02 of the native graph's;
     two builds of the first 65,536 rows bit-identical; a 4096 x 16
     integer build equal on the CPU (twins) and on the card;
 21. DynamicHNSWIndex(128, capacity=262,144) fed the set's first 131,072
     rows in two chunks: each chunk's inserts/s and launches, then its
     searcher's recall@10 against the exact top-10 of the inserted prefix;
     after the second chunk, the build's searches on the index's state,
     seeded by the greedy descent (ef=200, frontier=4): layer 0 for the
     next 512 rows over neighbors0, and level 1 for their upper sub-batch
     (136 slots) over the (N, 16) level-1 list table; on each, beam_step
     against beam_step_ref bit for bit after every step, and step 8 timed
     with its bound.

Phase 22 (after phase 11, on the same set) runs the command line,
``shine_tpu_torch.cli.main`` in this process with its output captured, from
phase 5's native graph (saved with ``save_graph`` before phase 6) and the set
with its exact top-10 (saved with ``save_dataset`` after phase 11), both in
a temporary directory under build/ that the phase removes; every run with
``-k 10 --batch 4096``, one [cli] line each (build ms, QPS, recall, the
counters, each kernel's launches) and its QPS beside the library call's at
the same knobs:

 22. --index hnsw --load-index (phase 5's build and search knobs): phase 5's
     f32 recall exactly, beam_step launched; --index hnsw --fast-build: phase
     16's pool-0 recall exactly, K2b launched; --index fastflat: phase 7's
     auto-route recall exactly, K2a launched; --index split (int8) and
     --index routed --probes 0: recall >= 0.90, K3 and K4 launched; --index
     auto --zipf 1.0 --warmup 1000: resolves to fastflat, recall >= 0.98;
     --index flat --num-queries 1000: the recall of FlatIndex.search on the
     same queries; then --synthetic 65536:128 --num-queries 1000 --index hnsw
     --device-build (its graph stored for phase 27d): recall >= 0.90,
     beam_step and gather_score launched;
     --index ivf --probes 32 --seed 1234 and --index ivf --ivf-routed --seed
     1234: the recall of phase 23's library call at the same seed and knobs
     exactly, gather_score (the probe rows and the re-rank) the only kernel
     launched.

Phase 25 (after phase 22, on the same set and phase 5's graph, loaded from
the file phase 22 served) ports the sharded HNSW path, its shards stacked on
the one card (``parallel/mesh.py``), ``SearchParams(k=10, ef=96,
frontier=8)``, batch 4096, the first 4,096 queries after a warm-up batch:

 25. ShardedIndex on nine routes: dense at S=4 and S=8, compact at S=8 with
     and without the slack ladder, bf16 rows at S=4, the static replica of
     100,000 vertices (the CLI's --cache ratio 0.1) and the adaptive one
     after ``warm`` at S=8, static and adaptive routing at S=4; each logs
     recall@10 (>= 0.90), QPS, K1's launches (> 0, no other kernel), the
     hit rate, rpc_rounds, lanes and wire bytes a query and the lockstep
     host reads a batch; ids agree with the single-card index of the same
     rows on >= 99.9% of slots; every f32 route gives dense S=4's ids and
     distance bits. Then one profiled S=8 dense batch; a 65,536
     x 16 integer-row graph (threads=1) served on a card mesh and a CPU
     mesh of 8 shards, dense and compact, with the replica and routing:
     ids, bits and counters equal; save_graph_sharded at S=4 under build/,
     loaded back equal and removed; the CLI in process: --index hnsw
     --load-index --num-queries 4096 --shards 4 --cache --routing (dense
     S=4's recall exactly, gather_score launched) and --index flat --shards 4
     --num-queries 1000 (phase 22's FlatIndex recall exactly). One
     [sharded] summary line.

Phase 26 ports the sharded scan families, every mesh 4 shards stacked on the
card (``shard_mesh(4)``), batch 4096; its parts run where their inputs are.
26a-c, f and g run after phase 25, on the 1M set and phase 22's saved copy:

 26a. ShardedFastFlatIndex (253,952 rows a shard) through phase 7's four
     routes (one K2 form each, launched once a shard a batch): recall@10
     (>= 0.98 at the auto knobs and the keep2 point, and at most 0.005 under
     phase 7's auto), QPS beside phase 7's; a profile of one auto batch;
     every K2 form on shard 0's table against its twin, K2a timed with its
     bound;
 26b. ShardedSplitFlatIndex.from_host (seed 1234), int8 and bf16, at the
     auto knobs: recall@10 (>= 0.90, >= 0.98), QPS, K3 launches, every id a
     real row; both K3 functions, keep1 and keep2, on shard 0 against their
     twins, the route's form timed;
 26c. ShardedIVFIndex (seed 1234, C = 7,816): compact search at probes 16,
     32, 64 (recall never falling) with rpc_rounds, scanned lanes and host
     reads a batch; a profile of one probes-32 batch; compact equal to
     dense id for id on one batch;
     search_routed at the command line's knobs; full probes over the first
     65,536 rows (recall@10 >= 0.99, rerank 8);
 26g. ROADMAP C11 for sharded FastFlat, split int8 and IVF (64 queries alone
     and in a batch of 2,048: equal ids and distance bits); a 65,536 x 16
     integer-row set on a card mesh and a CPU mesh, every family (FastFlat,
     split int8, IVF compact, dense and routed, routed split): ids, bits and
     counters equal;
 26f. the command line with --shards 4 --seed 1234: --index fastflat,
     split, routed --probes 0, ivf --probes 32 and ivf --ivf-routed, each
     reading its library run's recall exactly (routed: the build at its
     defaults with shards=4, dealt by from_single) and launching its kernels
     (the tile-shared IVF search launches none).

 26d runs in phases 12-13, on phase 12's index (C = 1,076, a multiple of 4):
     ShardedRoutedSplitIndex.from_single in base mode at the auto knobs and
     the starved grant with its spill: coverage equal to the single card's,
     recall@10 >= 0.90 at the auto knobs, overflow, lanes, spilled queries,
     QPS, K4 launches; K4 on shard 0 (270 clusters, 98 lanes) against its
     twin, timed.
 26e runs in phase 24, on row-keyed data (seed 17): the 1M split and ext
     datasets ingested over the mesh equal phase 24's, tables and ground
     truth, bit for bit, then served by from_dataset (kb=64) and from_ext
     with the row source (recall@10 >= 0.90, K3 or K2 and regen_score
     launched); build_routed_split_sharded of 4,194,304 rows (cap_target
     4096, cls 1024, int8) with its stage seconds and peak allocated memory,
     served at 32:256:32 (recall@10 >= 0.90); at 262,144 rows the direct
     build equal to from_single of build_routed_split(shards=4), bit for bit.

One [sharded-scan] summary line follows the last phase; each kernel's entry
in the JSON table gains the launches of every phase-26 run that ran it and,
for K2a, K3 keep1 and K4 at T=64, its numbers at a shard's shape.

Phase 27 ports the sharded builds, every mesh 4 shards stacked on the card;
it runs after phase 26, on the 1M set and phase 22's saved copy:

 27a. device_build_graph(mesh=4) of the first 65,536 rows at phase 20's
     settings: levels, lists and entry point bit for bit with phase 20's
     single-card build of them; its rounds, the plan, gather and apply
     seconds, the stage seconds and K1's launches;
 27b. DynamicHNSWIndex(128, capacity=131,072, mesh=4) fed those rows in two
     chunks beside a single-card index: bit-identical snapshots after each
     chunk, each side's seconds; its ShardedIndex searcher: recall@10 >=
     0.90 against the prefix's exact top-10, >= 99.9% of ids the single
     searcher's;
 27c. fast_build_graph(mesh=4) at 1M, the rows not resident: K2 once a
     shard a kNN batch (layer 0 and level 1), K1 in the re-rank, the stage
     seconds; served as in phase 5, recall@10 within 0.01 of phase 16's
     pool-0 graph;
 27d. the command line with --shards 4: --device-build and --fast-build on
     --synthetic 65536:128 (the stored graphs equal phase 22's single-card
     device build and the library's mesh fast build, and served by the
     library's ShardedIndex read the command line's recall), --index auto
     on phase 22's files (26f's FastFlat recall exactly), and --megabatch
     on one card (phase 22's FastFlat recall and K2a launches);
 27e. dryrun_mesh(8) stacked on the card.

One [sharded-build] summary line; K1's and K2's entries in the JSON table
gain phase 27's launches by run (``sharded_build_launches``).

Phase 28 runs last, after phase 24, and ports the JAX package's HNSW scale
recipe (``scripts/torch_scale_hnsw.py``) and checks rows past element 2^31:

 28a. the script's own run() at 262,144 x 128, M=32, pool 0 (seed 29, 2,048
     queries, exact top-11 on the card, the margin mask, the numpy
     crosscheck, fast_build_graph through the fused device sweep with its
     stage file, the checkpoint), f32, bf16 and int8 rows served at ef=96:
     recall@10 >= 0.90 on each and beam_step launched; then the build again
     from the stage file (layer 0 loaded, not built): levels, lists and entry
     point bit for bit with the first;
 28b. 16,781,312 x 128 Gaussian rows (2^24 + 4096: the last 4,096 start past
     element 2^31 of the f32, bf16 and int8 rows) and 64 queries equal to rows
     of that tail: K2 (FastFlat at the auto knobs), K3 (split bf16 at the
     auto knobs), gather_score on candidate lists of tail rows (against its
     plain version) and the layer-0 beam_step loop over lists that join only
     the tail, seeded one row before each query's own (f32, bf16 and int8
     rows), each return each query's own row first.

One [scale] summary line; every kernel's entry in the JSON table gains its
phase-28 launches by run (``scale_launches``).

Phase 29 runs last, after phase 28, and ports the JAX package's last on-card
recipes, cut in rows (``scripts/torch_scale_validation.py`` and
``scripts/torch_exp_skew.py``, each script's own run()):

 29a. the 10M validation recipe at 250,000 x 128 (253,952 rows once rounded
     up; seed 17, 2,048 queries, exact top-11 on the card, the margin mask,
     the numpy crosscheck): FastFlatIndex.from_device at the JAX package's
     defaults (shuffled: the rows are under SHUFFLE_MAX_BYTES) served at the
     JAX script's five (kb, cls, keep2) points and the shuffle=True index at
     the first, recall@10 >= 0.90 at each; the IVF fine layout by search
     (probes 8, 16, 32) and the coarse one (2,048 clusters) by search_routed
     at three points, recall@10 >= 0.90 there; no returned id outside
     [0, n); K2 and K1 launched; then the shuffle rule with
     SHUFFLE_MAX_BYTES set under the rows' size: no permutation, and the
     table is the rows packed in generator order;
 29b. the skew x budget grid on the routed split index at 262,144
     row-keyed rows (seed 17, a pool of 2,048, a stream of 2,048, cap_target
     4096, cls 1024, int8): alpha 0, 0.75, 1.25 x probes 16, 32, 64 at
     12 x p shared clusters, tile 32, no spill: recall@10 >= 0.90 in every
     cell, each stream's pool indices equal to a numpy recomputation, K4
     launched.

One [validation] summary line; every kernel's entry in the JSON table gains
its phase-29 launches by run (``validation_launches``, ``skew_launches``).

Phase 30 runs last, after phase 29, on phase 5's graph and phase 22's saved
set (kept until then), and drives the experiment scripts through their own
run():

 30a. scripts/torch_latency_probe.py at B 1 and 64: HNSW (ef=64, frontier 8)
     and FastFlat (tq 128) on the 1M set, the best of 5 calls, p50/p99 of 40
     (bench.py's rule) and one call's profile: beam_step launched in every
     HNSW call, a K2 form in every FastFlat call, p99 >= p50; at each B the
     HNSW search served again on the card reads the probe's recall@10, and
     its top-10 overlaps the CPU twin's (the kernels' plain versions, same
     graph, ef and queries) by >= 0.99;
 30b. scripts/torch_exp_sweep.py: two `python -m shine_tpu_torch` children
     (--data-path of the saved set, --load-index of the graph, --shards 8,
     --zipf 1.25, ef 128, 1,000 queries, the replica off and at 10%): both
     exit 0, recall@10 >= 0.90 and equal, hit rate 0 and > 0;
 30c. scripts/torch_exp_ici_exchange.py at one grid point (compact exchange,
     a 15% replica, alpha 1.25; its 20,000 x 32 graph built natively): wire
     bytes, lanes, rounds and hit rate > 0, gather_score launched;
 30d. scripts/torch_exp_routed_sharded.py at P_loc 6 (65,536 row-keyed
     rows, 8 shards): owned lanes and coverage > 0, K4 and regen_score
     launched.

One [experiments] summary line; every kernel's entry in the JSON table gains
its phase-30 launches by run (``experiments_launches``).

Phase 23 (after phase 11, before phase 22, on the same set) ports the IVF
family; IVF has no kernel of its own (the JAX package's products are XLA):
on the card it scores the probed rows and re-ranks through K1's
gather_score, one fixed sum order per (query, row) (ROADMAP C11):

 23. IVFIndex(base, seed=1234) built on the host (C=7,813, cap 160), its
     stage seconds (k-means, choices, capacity assignment, fill, upload) and
     layout invariants (every id once, no cluster over cap, pads -1, +inf,
     zero rows); search at probes 16, 32 and 64, batch 4096, recall@10
     (never falling as probes rise) and QPS after a warm-up batch; 256
     queries on a CPU copy of the layout against the card (id overlap >=
     0.99); probe_chunk=4 bit for bit with the default on one batch of
     4096 (ivf_search); search_routed on
     this layout at the command line's knobs (what --ivf-routed serves);
     a profile of one probes-32 batch; full probes over the set's first
     65,536 rows in 512 clusters (recall@10 >= 0.99 against their exact
     top-10, 1,000 queries, rerank 8); the routed layout (C=2,048, cap 611)
     served by search_routed at the command line's knobs and bench.py's
     (probes 16, shared 128, tile 64) with coverage and spilled queries, a
     profile of one batch, and fallback=1.1 equal to search at probes 16,
     id for id; IVFIndex.from_device on the card-resident base with its
     stage seconds, the same invariants, recall@10 at probes 32 within 0.02
     of the host build's. One [ivf] summary line.

Phases 12 and 13 run on a second set, 4,194,304 x 128 (10,000 queries, L2,
seed 7), the JAX package's smallest measured routed operating point, with
exact ground truth on the card:

 12. RoutedSplitIndex: the clustered build on the card from the raw rows at
     the command line's defaults (cap_target=4096, cls=1024, int8, slack
     1.05, assign_r=8, seed 1234; the base stays resident), its stage
     times and assignment-rank histogram; all queries at batch 4096 on
     three routes (the auto knobs: probes=32, T=64, shared=192, kk=80,
     fallback 0.5; tile=32; a starved grant, shared=32, whose fallback
     spill runs T=16 tiles), recall@10, QPS after a warm-up batch,
     coverage, the spill and K4's launches by form; a one-batch profile
     at the auto knobs; then 256 queries on the CPU (twins) and the card;
     then a second build of the same seed, which must place every row as
     the first did (ROADMAP C9: equal r0, centroids and layout, the same
     starved spill);
 13. K4 against its plain twin at each route's own inputs (the auto and
     tile=32 routes' first batch, the starved route's spill batch), on
     the index's int8 table and a bf16 table packed in the same order,
     L2 and IP; CUDA-event timings of the kernel, the twin and a bf16
     torch.bmm of each group's queries against its gathered blocks (the
     yardstick, gather untimed, never called by the port).

Phase 24 runs last, on row-keyed data (rows regenerated by id from the
JAX package's threefry at seed 17, d=128, L2, 2048 queries):

 24. the capacity path: (a) regen_rows on 1,048,576 ids and regen_score at
     B=4096, kk=80 against their plain versions, bit for bit, L2 and IP,
     with CUDA-event times and the bound; (b) bench.py's capacity_split_1m
     row (device_rowkeyed_split_dataset, int8, SplitFlatIndex.from_parts
     with the row source, kb=64, batch 2048: recall@10 >= 0.90, K3 int8 and
     regen_score launched); (c) the row-keyed ext table at the same size
     through FastFlatIndex.from_ext with the row source at the auto knobs
     (the same gate, K2 and regen_score launched); (d) capacity-routed-41.9m:
     build_routed_split of 41,943,040 row-keyed rows with no resident base
     (cap_target 4096, cls 1024, int8, seed 17; stage times; peak allocated
     memory below the f32 base's 21.5 GB; the scorer crosscheck > 0.995),
     served at p:P:T 16:192:32 and 32:256:32 (recall@10 >= 0.90 there) and
     once with the fallback spill: recall, eps and margin recall, coverage,
     spilled queries, QPS, K4 and regen_score launches, one profile;
     (e) ROADMAP C11: FastFlat, split int8, routed, IVF and HNSW on a 65,536
     x 128 set serve 64 queries inside batches of 64, 2048 and 16,384 with
     equal ids and distance bits. One [capacity] summary line.

Every count of kernel launches is set to 0 just before the run it reads.
Each kernel's entry in the JSON table pairs those launches with the time,
error and bound taken at the shape its route ran. Any failure raises. On
success the last line is
{"ok": true, "device": {"platform": "gpu", ...}}; the line before it holds
nvidia-smi's name and power limit, and the one before that the kernel
table as JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from shine_tpu_torch import (
    DynamicHNSWIndex,
    FastFlatIndex,
    FlatIndex,
    HNSWIndex,
    IVFIndex,
    RoutedSplitIndex,
    SplitFlatIndex,
    build_routed_split,
    cli,
    device_build_graph,
    native,
)
from shine_tpu_torch.config import METRIC_IP, METRIC_L2, HNSWParams, SearchParams
from shine_tpu_torch.graph.soa import build_graph, host_search
from shine_tpu_torch.io import (
    load_dataset,
    load_graph,
    load_graph_sharded,
    margin_mask,
    recall_at_k,
    recall_at_k_eps_regen,
    save_dataset,
    save_graph,
    save_graph_sharded,
    synthetic_dataset,
)
from shine_tpu_torch.io import device_synth as tds
from shine_tpu_torch.models import routed_split as rs
from shine_tpu_torch.models.ivf import IVFData, build_ivf_layout, ivf_search
from shine_tpu_torch.models.fastbuild import fast_build_graph
from shine_tpu_torch.models import build as tb
from shine_tpu_torch.models import hnsw as th
from shine_tpu_torch.models.hnsw import _extend_query, quantize_rows
from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops import blockmax as bm
from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops import scan_routed as k4
from shine_tpu_torch.ops import beam_step as bs
from shine_tpu_torch.ops import regen as rg
from shine_tpu_torch.ops import threefry as tf
from shine_tpu_torch.ops.beam import Beam
from shine_tpu_torch.ops.distance import check_precision, exact_knn, squared_norms
from shine_tpu_torch.ops.gather_score import gather_score, gather_score_ref
from shine_tpu_torch.ops.scan import QUANTUM, pack_ext_query, pack_ext_table
from shine_tpu_torch.ops.scan_split import (
    SPLIT_QUANTUM,
    pack_split_device,
    pack_split_query,
    pack_split_tables,
)
from shine_tpu_torch.parallel import (
    ShardedFastFlatIndex,
    ShardedIndex,
    ShardedIVFIndex,
    ShardedRoutedSplitIndex,
    ShardedSplitFlatIndex,
    build_routed_split_sharded,
    shard_mesh,
)
from shine_tpu_torch.utils.meter import (
    PEAK_BF16,
    PEAK_F32,
    bound_ms,
    reset_launches,
    scan_bound,
)

N, D, NQ, SEED = 1_000_000, 128, 10_000, 7
B, K = 4096, 256  # bench batch; E * 2M = 8 * 32 candidate lanes per step
BUILD = HNSWParams(M=16, ef_construction=200)
SEARCH = SearchParams(k=10, ef=96, frontier=8)
RTOL, ATOL = 1e-5, 1e-3  # distances are O(1e3); the two sum in other orders
# FastFlat's L2 distances (down to ~10) are differences of terms up to ~8e3
# (|q|^2, 2<q, v>, |v|^2) whose f32 ulp is 9.8e-4; the two devices sum them
# in other orders
FLAT_ATOL = 4e-3
MIN_RECALL = 0.90
# phase 5b: the native host search against the served path, 2,000 queries;
# the JAX package's own test asks > 0.97 at ef=128 on a 5,000-row graph
ORACLE_NQ, ORACLE_EFS, ORACLE_MIN_OVERLAP = 2000, (96, 128), 0.95
# phase 5c: the builds' seeded draws on the card against the CPU, bit for bit
# (n = 2,700,000 sorts three rounds; 2,097,152 training ids of the routed
# build at 100,663,296 rows)
DRAW_PERMS = (1_000_000, 2_700_000)
DRAW_CHOICE = (1_000_000, 100_000)
DRAW_RANDINT = (2_097_152, 100_663_296)
# the CPU twins' end-to-end checks; each check's seconds (both sides)
E2E_QUERIES, MIN_OVERLAP = 256, 0.99
E2E_SECONDS: list[float] = []
# K2 scores sum 144 bf16 products (each exact in f32) whose magnitudes add
# up to ~6.6e3 at most on this set: two f32 sums in other orders differ by
# at most 144 * 2^-23 * 6.6e3 = 0.11, so 0.25 is twice the worst case
K2_ATOL = 0.25
K2_SHAPES = ((2048, 64), (1024, 32))  # (cls, kb), checked beside the routes'
FLAT_MIN_RECALL = 0.98  # the JAX package read 0.9914-1.0000 on this shape
FLAT_ROUTE_MIN_RECALL = 0.90  # the two extra routes: broken, not mistuned
# the FastFlatIndex routes (name, search knobs): between them they launch
# every K2 form, each form on one route (flat_route_plan checks it)
FLAT_ROUTES = (
    ("auto", {}),
    ("keep2_point", {"tq": 256, "kb": 32, "keep2": True}),
    ("keep2_kb64", {"kb": 64, "keep2": True}),
    ("kb16", {"kb": 16}),
)
K2_FORMS = {
    "classmax_scan": (cm.classmax_scan, cm.classmax_scan_ref,
                      "shine_tpu/ops/pallas_scan3.py:209"),
    "classmax2_scan": (cm.classmax2_scan, cm.classmax2_scan_ref,
                       "shine_tpu/ops/pallas_scan3.py:170"),
    "classmax_topk_scan": (cm.classmax_topk_scan, cm.classmax_topk_scan_ref,
                           "shine_tpu/ops/pallas_scan3.py:411"),
    "classmax2_topk_scan": (cm.classmax2_topk_scan, cm.classmax2_topk_scan_ref,
                            "shine_tpu/ops/pallas_scan3.py:447"),
}


# K3 scores: 2<q, v> - ||v||^2 (or scl * <q, comp> + nrm for int8) from 128
# bf16 products, each exact in f32, summed in another order than the twin's
# f32 matmul: at most 128 * 2^-23 * sum|products| * scl, under 0.1 on this
# set; 0.25 as for K2
K3_ATOL = 0.25
SPLIT_DTYPES = ("bf16", "int8")
K3_EXTRA_SHAPE = (4096, 32)  # (cls, kb) the auto rule takes past 1,024,000 rows
SPLIT_MIN_RECALL = 0.98  # bf16 at the auto knobs: the floor FastFlat holds here
# the SplitFlatIndex routes: between them they launch every K3 form
SPLIT_ROUTES = (
    ("auto", {}),
    ("keep2_kb32", {"kb": 32, "keep2": True}),
    ("keep2_kb64", {"kb": 64, "keep2": True}),
    ("kb16", {"kb": 16}),
)
K3_FUNCS = {
    "classmax_scan_split": (cm.classmax_scan_split, cm.classmax_scan_split_ref,
                            "shine_tpu/ops/pallas_scan_split.py:176"),
    "classmax_topk_scan_split": (cm.classmax_topk_scan_split,
                                 cm.classmax_topk_scan_split_ref,
                                 "shine_tpu/ops/pallas_scan_split.py:267"),
}


# the routed set and build: the JAX package's 4.19M operating point
# (models/routed_split.py:_auto_probes) at the command line's defaults
# (shine_tpu/cli.py:368-372)
RN = 4_194_304
ROUTED_BUILD = dict(cap_target=4096, cls=1024, comp_dtype="int8", cap_slack=1.05,
                    assign_r=8, seed=1234)
# the RoutedSplitIndex routes: the auto knobs (T=64), tile=32 (T=32), and a
# starved grant whose fallback spill runs T=16 tiles
ROUTED_ROUTES = (
    ("auto", {}),
    ("tile32", {"tile": 32}),
    ("starved", {"shared": 32}),
)
ROUTED_MIN_RECALL = 0.90
# K4's scores are K3's (scl * <q, comp> + nrm from 128 bf16 products on the
# same kind of rows), summed in another order than the twin's: K3's bound
K4_ATOL = K3_ATOL


T_START = time.perf_counter()


def log(*a) -> None:
    """A line of the run, after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f}", *a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_vs_twin(base: np.ndarray, queries: np.ndarray, dev) -> list[dict]:
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, base.shape[0], size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.1] = -1
    ids_t = torch.from_numpy(ids).to(dev)
    masked = ids_t < 0
    q = torch.from_numpy(queries[:B]).to(dev)
    cases = []
    for rows in ("f32", "bf16", "int8"):
        tables = {k: v.to(dev) for k, v in quantize_rows(base, rows).items()}
        vectors = tables.pop("vectors_ext")
        for metric, l2 in (("l2", True), ("ip", False)):
            q_ext, bias = _extend_query(q, 0 if l2 else 1)
            kw = dict(tables, l2=l2)
            if not l2:
                kw.pop("row_nrm", None)
            out = gather_score(vectors, q_ext, bias, ids_t, **kw)
            torch.cuda.synchronize()
            ref = gather_score_ref(vectors, q_ext, bias, ids_t, **kw)
            if not torch.equal(torch.isinf(out), masked):
                raise AssertionError(f"{rows}/{metric}: inf not exactly where id<0")
            err = float((out[~masked] - ref[~masked]).abs().max())
            if not torch.allclose(out[~masked], ref[~masked], rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{rows}/{metric}: kernel disagrees, max err {err}")
            ms = cuda_ms(lambda: gather_score(vectors, q_ext, bias, ids_t, **kw))
            plain_ms = cuda_ms(
                lambda: gather_score_ref(vectors, q_ext, bias, ids_t, **kw))
            # each valid row read once; ids, queries, bias, scales, output
            row_bytes = vectors.element_size() * D + (8 if rows == "int8" else 0)
            nbytes = (int((~masked).sum()) * row_bytes + B * K * 8
                      + B * (D + 1) * 4)
            flops = 4.0 * int((~masked).sum()) * D  # dot and square-sum
            bms, by = bound_ms(nbytes, flops, PEAK_F32)
            cases.append(dict(rows=rows, metric=metric, max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by))
            log(f"[K1] {rows:4s} {metric}: max_abs_err={err:.3e} kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del vectors, tables
    return cases


def flat_route_plan(index: FastFlatIndex) -> list[tuple]:
    """(route, knobs, kernel, cls, kb) of each FastFlatIndex route, from the
    index's own knob resolution; fails unless the routes launch every K2
    form, each on one route."""
    plan = []
    for route, knobs in FLAT_ROUTES:
        kb, cls, keep2, fused = index._resolve_knobs(
            knobs.get("kb", 0), 0, knobs.get("keep2"), None, False)
        kernel = (("classmax2" if keep2 else "classmax")
                  + ("_topk" if fused else "") + "_scan")
        plan.append((route, knobs, kernel, cls, min(kb, cls)))
    if sorted(p[2] for p in plan) != sorted(K2_FORMS):
        raise AssertionError(f"the routes launch {[p[2] for p in plan]}, not "
                             "each K2 form once")
    return plan


def _k2_bound(name: str, cls: int, kb: int | None) -> tuple[float, str]:
    """The work the function needs: the N real rows at width D+2 (the
    port's zero columns and pad rows add none), B queries, the outputs."""
    width = D + 2
    planes = 4 if name.startswith("classmax2") else 2
    return scan_bound(N, B, width, width * 2, B * (cls if kb is None else kb) * planes)


def _k2_err(got, want, cls: int) -> float:
    """Largest score difference of a form's outputs against its twin's.
    Where two classes' best scores lie within K2_ATOL the kernel may order
    them otherwise than the twin, so a fused form's runner-ups are compared
    only where both picked the same lane (row % cls) at that position."""
    err = float((got[0] - want[0]).abs().max())
    if len(got) == 4:
        same = (got[1] % cls) == (want[1] % cls)
        err = max(err, float((got[2] - want[2])[same].abs().max()))
    return err


def _check_rescored(ext, q, planes, name: str) -> None:
    """Each selected row, scored again in f32 from the table, has the
    score reported beside it (runner-ups that never entered excepted)."""
    qf = q.float()
    for s, r in zip(planes[::2], planes[1::2]):
        rescored = torch.einsum("bd,bkd->bk", qf, ext[r.long()].float())
        real = s > -3e38
        err = float((rescored - s)[real].abs().max())
        if err > K2_ATOL:
            raise AssertionError(f"{name}: a selected row scores {err} away "
                                 "from its reported score")


def _k2_form(name, ext, q, metric: str, cls: int, kb: int | None,
             cases: dict[str, list]) -> tuple:
    """One form at one shape against its twin; times it under L2 and
    records the case. Returns the kernel's outputs."""
    fn, ref, _ = K2_FORMS[name]
    kw = {"cls": cls} if kb is None else {"cls": cls, "kb": kb}
    got = fn(ext, q, **kw)
    torch.cuda.synchronize()
    err = _k2_err(got, ref(ext, q, **kw), cls)
    if err > K2_ATOL:
        raise AssertionError(f"{name} {metric} cls={cls} kb={kb}: scores "
                             f"differ by {err} > {K2_ATOL}")
    case = {"metric": metric, "cls": cls, "kb": kb, "max_abs_err": err}
    msg = f"[K2] {name} {metric} cls={cls} kb={kb}: max_abs_err={err:.3e}"
    if metric == "l2":  # time the slice's own metric
        case["ms"] = cuda_ms(lambda: fn(ext, q, **kw), reps=10)
        case["plain_ms"] = cuda_ms(lambda: ref(ext, q, **kw), reps=3, warmup=1)
        case["bound_ms"], case["bound_by"] = _k2_bound(name, cls, kb)
        msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} "
                f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
    cases[name].append(case)
    log(msg)
    return got


def k2_vs_twin(base: np.ndarray, queries: np.ndarray, dev,
               shapes: dict[int, list[int]]) -> tuple[dict[str, list], float]:
    """All four K2 forms against their twins on the set's packed tables:
    the unfused forms at each cls of ``shapes``, the fused forms at each
    of its (cls, kb). Returns each form's cases and the yardstick's ms."""
    n_pad = -(-N // QUANTUM) * QUANTUM
    cases: dict[str, list] = {name: [] for name in K2_FORMS}
    library_ms = None
    for metric, mid in (("l2", 0), ("ip", 1)):
        ext = pack_ext_table(base, mid, n_pad, device=dev)
        dp = ext.shape[1]
        q = pack_ext_query(torch.from_numpy(queries[:B]).to(dev), dp).to(
            torch.bfloat16)
        for cls, kbs in shapes.items():
            lane = torch.arange(cls, device=dev, dtype=torch.int32)
            t1, tr1, t2, _ = cm.classmax2_scan_ref(ext, q, cls=cls)
            clear = (t1 - t2) > K2_ATOL  # the twin's winner is unambiguous
            unfused = {}
            for name in ("classmax_scan", "classmax2_scan"):
                got = _k2_form(name, ext, q, metric, cls, None, cases)
                if not torch.equal(got[1] % cls, lane.expand_as(got[1])):
                    raise AssertionError(f"{name}: a row outside its class")
                if not torch.equal(got[1][clear], tr1[clear]):
                    raise AssertionError(f"{name} {metric} cls={cls}: rows "
                                         "differ where the winner is clear")
                unfused[name] = got
            for kb in kbs:
                for name in ("classmax_topk_scan", "classmax2_topk_scan"):
                    got = _k2_form(name, ext, q, metric, cls, kb, cases)
                    _check_rescored(ext, q, got, name)
                    # the fused select == unfused form + select, bit for bit
                    base_form = unfused[name.replace("_topk", "")]
                    vals, sel = cm.select_lanes(base_form[0], kb)
                    expect = (vals,) + tuple(torch.gather(p, 1, sel)
                                             for p in base_form[1:])
                    if not all(torch.equal(g, e) for g, e in zip(got, expect)):
                        raise AssertionError(f"{name} {metric} cls={cls} kb="
                                             f"{kb}: the fused select is not "
                                             "the unfused form plus select")
            del t1, tr1, t2, clear, unfused
        if metric == "l2":
            # the yardstick: the bare bf16 product in 65,536-row chunks
            def product():
                for lo in range(0, n_pad, 65_536):
                    torch.matmul(q, ext[lo:lo + 65_536].T)
            library_ms = cuda_ms(product, reps=10)
            log(f"[K2] torch.matmul bf16 ({B}, {dp}) x ({n_pad}, {dp})^T in "
                f"65,536-row chunks: {library_ms:.4f} ms")
        del ext, q
        torch.cuda.empty_cache()
    return cases, library_ms


def serve(graph, ds, gt, rows: str, dev, what: str = "native") -> tuple[int, float, float]:
    """Search all queries on ``rows`` rows; check recall and beam_step's
    launches in that run (one a layer-0 step, and the gated no-ops after
    the last), and return (launches, recall@10, QPS)."""
    t0 = time.perf_counter()
    index = HNSWIndex(graph, rows=rows, device=dev)
    torch.cuda.synchronize()
    log(f"[hnsw] upload {rows} rows: {time.perf_counter() - t0:.2f} s")
    index.search(ds.queries, SEARCH, batch_size=B)  # warm-up pass
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = index.search(ds.queries, SEARCH, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bs.beam_step.launches
    recall = recall_at_k(ids, gt, 10)
    log(f"[hnsw] {what} graph, {rows}: recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"wall={wall:.3f} s mean_hops={index.last_hops / NQ:.2f} "
        f"mean_dist_comps={index.last_dists / NQ:.1f} "
        f"beam_steps={index.last_steps} beam_step_launches={launches} "
        f"gather_score_launches={gather_score.launches}")
    if recall < MIN_RECALL:
        raise AssertionError(f"{rows}: recall@10 {recall:.4f} < {MIN_RECALL}")
    if not launches >= index.last_steps > 0:
        raise AssertionError(
            f"{rows}: {launches} beam_step launches for {index.last_steps} beam steps")
    return launches, recall, NQ / wall


def host_oracle(graph, ds, gt, dev) -> dict:
    """5b: ``host_search`` (the native k-NN of the reference, on the host)
    against the served path (the dense entry, then one ``beam_step`` a
    layer-0 step) on the first ORACLE_NQ queries at each ef of ORACLE_EFS,
    ``SearchParams(k=10, frontier=8)``: the overlap of their top-10s and
    each side's recall@10; fails below ORACLE_MIN_OVERLAP at the last ef."""
    q, g = ds.queries[:ORACLE_NQ], gt[:ORACLE_NQ]
    index = HNSWIndex(graph, rows="f32", device=dev)
    out = {}
    for ef in ORACLE_EFS:
        t0 = time.perf_counter()
        h_ids, h_d = host_search(graph, q, 10, ef)
        host_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        c_ids, _ = index.search(q, SearchParams(k=10, ef=ef, frontier=8), batch_size=B)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        if not np.all(np.diff(h_d, axis=1) >= 0) or (h_ids < 0).any():
            raise AssertionError(f"5b ef={ef}: host_search returned a short or unsorted list")
        if bs.beam_step.launches < index.last_steps or not index.last_steps:
            raise AssertionError(f"5b ef={ef}: beam_step launched {bs.beam_step.launches} "
                                 f"times for {index.last_steps} steps")
        out[ef] = {"overlap": recall_at_k(c_ids, h_ids, 10),
                   "host_recall@10": recall_at_k(h_ids, g, 10),
                   "card_recall@10": recall_at_k(c_ids, g, 10),
                   "host_s": host_s, "card_s": card_s,
                   "beam_step_launches": bs.beam_step.launches}
        log(f"[oracle] 5b ef={ef}, {ORACLE_NQ} queries: {json.dumps(out[ef])}")
    del index
    torch.cuda.empty_cache()
    last = out[ORACLE_EFS[-1]]["overlap"]
    if last < ORACLE_MIN_OVERLAP:
        raise AssertionError(f"5b: the served path's top-10 overlaps host_search's by "
                             f"{last:.4f} at ef={ORACLE_EFS[-1]} < {ORACLE_MIN_OVERLAP}")
    return out


def draws_on_card(dev) -> dict:
    """5c: the seeded draws of the builds (``ops/threefry.py``), drawn on the
    card and on the CPU from one key: ``permutation`` at each of DRAW_PERMS,
    ``choice`` at DRAW_CHOICE and ``randint`` at DRAW_RANDINT, bit for bit."""
    out = {}

    def same(name: str, draw) -> None:
        t0 = time.perf_counter()
        got = draw(dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        want = draw(torch.device("cpu"))
        if not torch.equal(got.cpu(), want):
            bad = int((got.cpu() != want).sum())
            raise AssertionError(f"5c {name}: the card's draw differs from the CPU's "
                                 f"at {bad} of {want.numel()} places")
        out[name] = {"card_s": card_s, "numel": want.numel()}

    for n in DRAW_PERMS:
        same(f"permutation({n})", lambda d, n=n: tf.permutation(
            tf.prng_key(SEED), n, device=d))
    n, k = DRAW_CHOICE
    same(f"choice({n}, {k})", lambda d: tf.choice(tf.prng_key(1234), n, k, device=d))
    ts, n = DRAW_RANDINT
    same(f"randint({ts}, 0, {n})", lambda d: tf.randint(
        tf.prng_key(CAP_SEED).to(d), (ts,), 0, n))
    log(f"[draws] 5c bit for bit on the card and the CPU: {json.dumps(out)}")
    return out


def _e2e_timed(fn):
    """An end-to-end check whose seconds go into E2E_SECONDS."""
    def run(*args, **kw):
        t0 = time.perf_counter()
        fn(*args, **kw)
        E2E_SECONDS.append(time.perf_counter() - t0)
    return run


def _compare(a_ids, a_d, b_ids, b_d, what: str, atol: float = ATOL) -> None:
    overlap = recall_at_k(b_ids, a_ids, 10)
    same = a_ids[:, :, None] == b_ids[:, None, :]  # (Q, k, k) id matches
    qi, ai, bi = np.nonzero(same)
    da, db = a_d[qi, ai], b_d[qi, bi]
    err = float(np.abs(da - db).max())
    log(f"[e2e] {what}: {len(a_ids)} queries cpu vs cuda: id overlap="
        f"{overlap:.4f} matched={len(qi)} max_abs_dist_err={err:.3e}")
    if overlap < MIN_OVERLAP:
        raise AssertionError(f"{what}: cpu/cuda id overlap {overlap:.4f} < "
                             f"{MIN_OVERLAP}")
    np.testing.assert_allclose(db, da, rtol=RTOL, atol=atol)


@_e2e_timed
def hnsw_end_to_end(graph, ds, dev) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = HNSWIndex(graph, rows="f32", device="cpu")
    a_ids, a_d = cpu.search(q, SEARCH, batch_size=E2E_QUERIES)
    gpu = HNSWIndex(graph, rows="f32", device=dev)
    b_ids, b_d = gpu.search(q, SEARCH, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, "hnsw")


# --- phase 19: K1's fused beam step ------------------------------------------

STEP_QUERIES = 512  # queries of the whole searches compared step by step
MID_STEP = 8  # the step timed at B=4096, mid-search (~23 steps a batch)
DESCENT = SearchParams(k=10, ef=96, frontier=8, entry_mode="descent")
# the descent entry's floor: the greedy walk seeds one entry instead of the
# dense sweep's two, so its recall may sit a little under the dense entry's;
# below this it is broken, not mistuned
DESCENT_MIN_RECALL = 0.80


def _step_state(g, queries: np.ndarray, sp: SearchParams, dev) -> tuple:
    """(q_ext, bias, state): the dense entry's seeded layer-0 state."""
    q_ext, bias = _extend_query(torch.from_numpy(queries).to(dev), METRIC_L2)
    seed_ids, seed_d, _ = th._seeds(g, q_ext, bias, sp, True)
    return q_ext, bias, list(th._l0_state(seed_ids, seed_d, sp))


def _run_step(fn, g, q_ext, bias, state, t: int, sp: SearchParams) -> None:
    beam, hops, counts, uns = state
    fn(g.vectors_ext, g.neighbors0, q_ext, bias, beam, hops, counts, uns, t,
       frontier=sp.frontier, k=sp.k, term=sp.term, l2=True, row_scl=g.row_scl,
       row_nrm=g.row_nrm)


def _flat(state) -> list[torch.Tensor]:
    return list(state[0]) + list(state[1:])


def _clone_state(state) -> list:
    return [Beam(*(c.clone() for c in state[0]))] + [x.clone() for x in state[1:]]


def step_vs_twin(g, q_ext, bias, fused: list, sp: SearchParams, what: str
                 ) -> tuple[int, int]:
    """beam_step against beam_step_ref from the same seeded state ``fused``
    on ``g``'s rows and lists, bit for bit (dists as int32 words) after
    every step of a whole search. Returns (steps, entries compared)."""
    plain = _clone_state(fused)
    for t in range(sp.max_steps):
        _run_step(bs.beam_step, g, q_ext, bias, fused, t, sp)
        _run_step(bs.beam_step_ref, g, q_ext, bias, plain, t, sp)
        torch.cuda.synchronize()
        a, b = _flat(fused), _flat(plain)
        a[0], b[0] = a[0].view(torch.int32), b[0].view(torch.int32)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"beam_step {what}: differs from beam_step_ref "
                                 f"at step {t}")
        if int(fused[3][t + 1]) == 0:
            return t + 1, fused[0].ids.numel()
    return sp.max_steps, fused[0].ids.numel()


def _timed_step(fn, state, snapshot, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()``, the state restored from
    ``snapshot`` before each run (outside the timed window)."""
    times = []
    for i in range(warmup + reps):
        for x, y in zip(_flat(state), _flat(snapshot)):
            x.copy_(y)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def step_timing(g, q_ext, bias, state: list, sp: SearchParams, what: str) -> dict:
    """One mid-search step (step MID_STEP) of the seeded batch ``state``: the
    fused kernel and its twin by CUDA events, the lanes that hold an id and
    the ones kept after the duplicate drop, and the step's bound: the kept
    rows' bytes, the active lists, the beam read and written, the query rows
    and the counters, over the card's memory rate."""
    nq = q_ext.shape[0]
    for t in range(MID_STEP):
        _run_step(bs.beam_step, g, q_ext, bias, state, t, sp)
    t = MID_STEP
    if int(state[3][t]) == 0:
        raise AssertionError(f"beam_step {what}: the batch settled before step {t}")
    snapshot = _clone_state(state)
    _, active, lanes = bs.frontier_lists(state[0], g.neighbors0, sp.frontier)
    kept = bs.kept_lanes(state[0].ids, lanes)
    n_lanes, n_valid = lanes.numel(), int((lanes >= 0).sum())
    n_kept, n_active = int(kept.sum()), int(active.sum())
    W = g.neighbors0.shape[1]
    ms = _timed_step(lambda: _run_step(bs.beam_step, g, q_ext, bias, state, t, sp),
                     state, snapshot)
    plain_ms = _timed_step(
        lambda: _run_step(bs.beam_step_ref, g, q_ext, bias, state, t, sp),
        state, snapshot, reps=5, warmup=1)
    row_bytes = (g.vectors_ext.element_size() * D
                 + (8 if g.row_scl is not None else 0))
    nbytes = (n_kept * row_bytes + n_active * W * 4 + 2 * nq * sp.ef * 9
              + nq * (D + 1) * 4 + 2 * nq * 8)
    bms, by = bound_ms(nbytes, 4.0 * n_kept * D, PEAK_F32)
    log(f"[K1] beam_step {what}, step {t} of a batch of {nq} (ef={sp.ef}, frontier="
        f"{sp.frontier}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); lanes {n_lanes}, with an id {n_valid} "
        f"({100 * n_valid / n_lanes:.1f}%), kept after the duplicate drop {n_kept} "
        f"({100 * n_kept / max(n_valid, 1):.1f}% of those), active frontier slots "
        f"{n_active}")
    return dict(rows=what, batch=nq, ef=sp.ef, frontier=sp.frontier, step=t, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, lanes=n_lanes,
                valid_lanes=n_valid, kept_lanes=n_kept, active_slots=n_active)


def serve_descent(graph, ds, gt, dev) -> dict:
    """All queries through the descent entry on f32 rows: the greedy walk
    and the entry point's distance launch gather_score, the layer-0 steps
    beam_step. Checks both launch counts and the recall."""
    index = HNSWIndex(graph, rows="f32", device=dev)
    index.search(ds.queries, DESCENT, batch_size=B)  # warm-up pass
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = index.search(ds.queries, DESCENT, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, step = gather_score.launches, bs.beam_step.launches
    recall = recall_at_k(ids, gt, 10)
    log(f"[hnsw] descent entry, f32: recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"mean_hops={index.last_hops / NQ:.2f} beam_steps={index.last_steps} "
        f"gather_score_launches={k1} beam_step_launches={step}")
    if recall < DESCENT_MIN_RECALL:
        raise AssertionError(f"descent: recall@10 {recall:.4f} < {DESCENT_MIN_RECALL}")
    if k1 == 0 or not step >= index.last_steps > 0:
        raise AssertionError(f"descent: {k1} gather_score and {step} beam_step "
                             f"launches for {index.last_steps} steps")
    return {"gather_score_launches": k1, "beam_step_launches": step,
            "recall@10": recall, "qps": NQ / wall}


def beam_step_phase(graph, ds, gt, dev) -> tuple[list[dict], dict]:
    """Phase 19; returns beam_step's cases (one a row type) and the descent
    entry's run."""
    sp = SEARCH.resolved()
    cases = []
    for rows in ("f32", "bf16", "int8"):
        g = th.device_graph(graph, rows=rows, device=dev)
        steps, entries = step_vs_twin(
            g, *_step_state(g, ds.queries[:STEP_QUERIES], sp, dev), sp, rows)
        log(f"[K1] beam_step {rows}: equal to beam_step_ref bit for bit after each "
            f"of the {steps} steps of {STEP_QUERIES} queries ({entries} beam entries)")
        case = step_timing(g, *_step_state(g, ds.queries[:B], sp, dev), sp, rows)
        case.update(max_abs_err=0.0, search_steps_compared=steps)
        cases.append(case)
        del g
        torch.cuda.empty_cache()
    index = HNSWIndex(graph, rows="f32", device=dev)
    profile_run(lambda: index.search(ds.queries[:B], SEARCH, batch_size=B),
                "hnsw f32")
    del index
    descent = serve_descent(graph, ds, gt, dev)
    return cases, descent


def serve_flat(index: FastFlatIndex, ds, gt, plan) -> tuple[dict, dict]:
    """All queries through each scan route; returns each route's kernel
    launches, checked non-zero, and its (recall@10, QPS), both logged."""
    launches, served = {}, {}
    pre = index.preload(ds.queries, batch_size=B)
    for route, knobs, kernel, cls, kb in plan:
        # warm-up: one pass of every query (one batch left the first
        # route's timed pass at a sixth of its speed after the native build)
        index.search(ds.queries, 10, batch_size=B, preloaded=pre, **knobs)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ids, _ = index.search(ds.queries, 10, batch_size=B, preloaded=pre,
                              **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, (fn, _, _) in K2_FORMS.items()}
        recall = recall_at_k(ids, gt, 10)
        log(f"[flat] {route}: {kernel} cls={cls} kb={kb} "
            f"recall@10={recall:.4f} qps={NQ / wall:.1f} wall={wall:.3f} s "
            f"launches={counts}")
        floor = FLAT_MIN_RECALL if route in ("auto", "keep2_point") \
            else FLAT_ROUTE_MIN_RECALL
        if recall < floor:
            raise AssertionError(f"fastflat {route}: recall@10 {recall:.4f} "
                                 f"< {floor}")
        if counts[kernel] == 0:
            raise AssertionError(f"fastflat {route}: {kernel} never launched")
        launches[kernel] = counts[kernel]
        served[route] = (recall, NQ / wall)
    return launches, served


@_e2e_timed
def flat_end_to_end(ds, gpu: FastFlatIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = FastFlatIndex(ds.base, device="cpu")
    for route, knobs in FLAT_ROUTES[:2]:
        a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES, **knobs)
        b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES, **knobs)
        _compare(a_ids, a_d, b_ids, b_d, f"fastflat {route}", FLAT_ATOL)


def split_route_plan(index: SplitFlatIndex) -> list[tuple]:
    """(route, knobs, function, keep2, cls, kb) of each SplitFlatIndex
    route, from the index's own knob resolution; fails unless the routes
    launch every K3 form (function x keep2), each on one route."""
    plan = []
    for route, knobs in SPLIT_ROUTES:
        kb, cls, keep2, fused = index._resolve_knobs(
            knobs.get("kb", 0), 0, knobs.get("keep2"), None, False)
        fn = "classmax_topk_scan_split" if fused else "classmax_scan_split"
        plan.append((route, knobs, fn, keep2, cls, min(kb, cls)))
    forms = sorted((p[2], p[3]) for p in plan)
    if forms != sorted((f, k2) for f in K3_FUNCS for k2 in (False, True)):
        raise AssertionError(f"the routes launch {forms}, not each K3 form once")
    return plan


def _k3_bound(keep2: bool, cls: int, kb: int | None, elt: int) -> tuple[float, str]:
    """The work the function needs: the N real rows at width D (the zero
    columns and pad rows add none), their aux, B queries, the outputs."""
    planes = 4 if keep2 else 2
    return scan_bound(N, B, D, D * elt + 8, B * (cls if kb is None else kb) * planes)


def _k3_rescored(comp, aux, q, planes, what: str) -> None:
    """Each selected row, scored again in f32 from the tables, has the
    score reported beside it (runner-ups that never entered excepted)."""
    qf = q.float()
    for s, r in zip(planes[::2], planes[1::2]):
        rl = r.long()
        dots = torch.einsum("bd,bkd->bk", qf, comp[rl].float())
        err = float((aux[1][rl] * dots + aux[0][rl] - s)[s > -3e38].abs().max())
        if err > K3_ATOL:
            raise AssertionError(f"{what}: a selected row scores {err} away "
                                 "from its reported score")


def _k3_form(fn_name, keep2, comp, aux, q, metric, cls, kb, cases) -> tuple:
    """One form at one shape against its twin; times it under L2 and
    records the case. Returns the kernel's outputs."""
    fn, ref, _ = K3_FUNCS[fn_name]
    kw = {"cls": cls, "keep2": keep2, **({} if kb is None else {"kb": kb})}
    got = fn(comp, aux, q, **kw)
    torch.cuda.synchronize()
    err = _k2_err(got, ref(comp, aux, q, **kw), cls)
    what = (f"{fn_name} {'int8' if comp.dtype == torch.int8 else 'bf16'} "
            f"keep2={keep2} {metric} cls={cls} kb={kb}")
    if err > K3_ATOL:
        raise AssertionError(f"{what}: scores differ by {err} > {K3_ATOL}")
    case = {"metric": metric, "cls": cls, "kb": kb, "max_abs_err": err}
    msg = f"[K3] {what}: max_abs_err={err:.3e}"
    if metric == "l2":
        case["ms"] = cuda_ms(lambda: fn(comp, aux, q, **kw), reps=10)
        case["plain_ms"] = cuda_ms(lambda: ref(comp, aux, q, **kw), reps=3, warmup=1)
        case["bound_ms"], case["bound_by"] = _k3_bound(keep2, cls, kb,
                                                       comp.element_size())
        msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} "
                f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
    cases[(fn_name, keep2)].append(case)
    log(msg)
    return got


def k3_vs_twin(base: np.ndarray, queries: np.ndarray, dev, plan,
               comp_dtype: str) -> tuple[dict, float]:
    """Every K3 form against its twin on the set's split tables of one
    comp dtype: the unfused forms at each cls of the plan and of
    K3_EXTRA_SHAPE, each fused form at its route's (cls, kb) and at
    K3_EXTRA_SHAPE. Returns each form's cases and the yardstick's ms."""
    n_pad = -(-N // SPLIT_QUANTUM) * SPLIT_QUANTUM
    shapes = {(fn, keep2): {(cls, kb if "topk" in fn else None),
                            (K3_EXTRA_SHAPE[0], K3_EXTRA_SHAPE[1] if "topk" in fn
                             else None)}
              for _, _, fn, keep2, cls, kb in plan}
    cases: dict = {form: [] for form in shapes}
    library_ms = None
    for metric, mid in (("l2", 0), ("ip", 1)):
        comp, aux = pack_split_tables(base, mid, n_pad, comp_dtype=comp_dtype,
                                      device=dev)
        q = pack_split_query(torch.from_numpy(queries[:B]).to(dev), comp.shape[1])
        for cls in sorted({c for form in shapes.values() for c, _ in form}):
            lane = torch.arange(cls, device=dev, dtype=torch.int32)
            t1, tr1, t2, _ = cm.classmax_scan_split_ref(comp, aux, q, cls=cls,
                                                        keep2=True)
            clear = (t1 - t2) > K3_ATOL  # the twin's winner is unambiguous
            unfused = {}
            for keep2 in (False, True):
                got = _k3_form("classmax_scan_split", keep2, comp, aux, q,
                               metric, cls, None, cases)
                if not torch.equal(got[1] % cls, lane.expand_as(got[1])):
                    raise AssertionError("classmax_scan_split: a row outside "
                                         "its class")
                if not torch.equal(got[1][clear], tr1[clear]):
                    raise AssertionError(f"classmax_scan_split keep2={keep2} "
                                         f"{metric} cls={cls}: rows differ "
                                         "where the winner is clear")
                unfused[keep2] = got
            for keep2 in (False, True):
                kbs = sorted(kb for c, kb in shapes[("classmax_topk_scan_split",
                                                     keep2)] if c == cls)
                for kb in kbs:
                    got = _k3_form("classmax_topk_scan_split", keep2, comp, aux,
                                   q, metric, cls, kb, cases)
                    _k3_rescored(comp, aux, q, got, "classmax_topk_scan_split")
                    vals, sel = cm.select_lanes(unfused[keep2][0], kb)
                    expect = (vals,) + tuple(torch.gather(p, 1, sel)
                                             for p in unfused[keep2][1:])
                    if not all(torch.equal(g, e) for g, e in zip(got, expect)):
                        raise AssertionError(
                            f"classmax_topk_scan_split {comp_dtype} keep2={keep2}"
                            f" {metric} cls={cls} kb={kb}: the fused select is "
                            "not the unfused form plus select")
            del t1, tr1, t2, clear, unfused
        if metric == "l2":
            # the yardstick: the bare bf16 product in 65,536-row chunks, on
            # the table widened to bf16 beforehand when it is int8
            wide = comp.to(torch.bfloat16)

            def product():
                for lo in range(0, n_pad, 65_536):
                    torch.matmul(q, wide[lo:lo + 65_536].T)
            library_ms = cuda_ms(product, reps=10)
            log(f"[K3] torch.matmul bf16 ({B}, {D}) x ({n_pad}, {D})^T in "
                f"65,536-row chunks ({comp_dtype} table"
                f"{', widened before timing' if comp_dtype == 'int8' else ''}): "
                f"{library_ms:.4f} ms")
            del wide
        del comp, aux, q
        torch.cuda.empty_cache()
    return cases, library_ms


def serve_split(index: SplitFlatIndex, ds, gt, plan) -> tuple[dict, dict]:
    """All queries through each route; returns each route's launches of
    its K3 form, checked non-zero, and its (recall@10, QPS), both logged."""
    launches, served = {}, {}
    pre = index.preload(ds.queries, batch_size=B)
    for route, knobs, fn, keep2, cls, kb in plan:
        index.search(ds.queries[:B], 10, batch_size=B, **knobs)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ids, _ = index.search(ds.queries, 10, batch_size=B, preloaded=pre,
                              **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {f"{name}[{dt},keep{2 if k2 else 1}]": n
                  for name, (f, _, _) in K3_FUNCS.items()
                  for (dt, k2), n in f.form_launches.items()}
        n = K3_FUNCS[fn][0].form_launches.get((index.comp_dtype, keep2), 0)
        recall = recall_at_k(ids, gt, 10)
        log(f"[split] {index.comp_dtype} {route}: {fn} keep2={keep2} cls={cls} "
            f"kb={kb} recall@10={recall:.4f} qps={NQ / wall:.1f} "
            f"wall={wall:.3f} s launches={counts}")
        floor = (SPLIT_MIN_RECALL if (route, index.comp_dtype) == ("auto", "bf16")
                 else FLAT_ROUTE_MIN_RECALL)
        if recall < floor:
            raise AssertionError(f"split {index.comp_dtype} {route}: recall@10 "
                                 f"{recall:.4f} < {floor}")
        if n == 0:
            raise AssertionError(f"split {index.comp_dtype} {route}: {fn} "
                                 f"keep2={keep2} never launched")
        launches[route] = n
        served[route] = (recall, NQ / wall)
    return launches, served


def profile_batch(index, queries: np.ndarray, what: str) -> None:
    """Device time by kernel over one batch of B queries at the auto knobs
    (torch.profiler, after a warm-up batch), and the card's busy share of
    the batch's host span."""
    pre = index.preload(queries[:B], batch_size=B)
    profile_run(lambda: index.search_device(pre, 10, batch_size=B), what)


def profile_run(run, what: str, batch: int = B) -> None:
    """``profile_batch`` of any one-batch call ``run`` of ``batch`` queries."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    # device events only: an operator's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {what}, one batch of {batch}: span {span_ms:.3f} ms (profiled), "
        f"device busy {busy:.3f} ms ({100 * busy / span_ms:.1f}%)")
    for ms, count, key in rows[:8]:
        if ms > 0:
            log(f"[profile]   {ms:8.4f} ms {100 * ms / busy:5.1f}% x{count} {key[:90]}")


@_e2e_timed
def split_end_to_end(ds, gpu: SplitFlatIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = SplitFlatIndex(ds.base, comp_dtype=gpu.comp_dtype, device="cpu")
    a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES)
    b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, f"split {gpu.comp_dtype} auto", FLAT_ATOL)


def split_phases(ds, gt, dev) -> tuple[list[dict], dict]:
    """Phases 9-11 for both comp dtypes; the K3 entries of the kernel
    table, each at the shape of the route whose launches it reports, and
    each (comp dtype, route)'s (recall@10, QPS)."""
    kernels, served = [], {}
    for comp_dtype in SPLIT_DTYPES:
        t0 = time.perf_counter()
        index = SplitFlatIndex(ds.base, comp_dtype=comp_dtype, device=dev)
        torch.cuda.synchronize()
        log(f"[split] SplitFlatIndex {comp_dtype} build (shuffle, host pack "
            f"{tuple(index.comp.shape)} + aux {tuple(index.aux.shape)}, copy to "
            f"the card): {time.perf_counter() - t0:.2f} s")
        plan = split_route_plan(index)
        cases, library_ms = k3_vs_twin(ds.base, ds.queries, dev, plan, comp_dtype)
        launches, by_route = serve_split(index, ds, gt, plan)
        served.update({(comp_dtype, r): v for r, v in by_route.items()})
        profile_batch(index, ds.queries, f"split {comp_dtype} auto")
        split_end_to_end(ds, index)
        del index
        torch.cuda.empty_cache()
        for route, _, fn, keep2, cls, kb in plan:
            kb = kb if "topk" in fn else None
            at = [c for c in cases[(fn, keep2)] if (c["cls"], c["kb"]) == (cls, kb)]
            main_k3 = next(c for c in at if c["metric"] == "l2")
            kernels.append({
                "name": f"{fn}[{comp_dtype},keep{2 if keep2 else 1}]",
                "route": "cuda",
                "source": "shine_tpu_torch/csrc/classmax2_scan.cu",
                "replaces": K3_FUNCS[fn][2],
                "launches": launches[route],
                "max_abs_err": max(c["max_abs_err"] for c in at),
                "ms": main_k3["ms"],
                "plain_ms": main_k3["plain_ms"],
                "bound_ms": main_k3["bound_ms"],
                "bound_by": main_k3["bound_by"],
                "library_ms": library_ms,
                "split_route": route,
                "comp_dtype": comp_dtype,
                "keep2": keep2,
                "cls": cls,
                "kb": kb,
                "cases": cases[(fn, keep2)],
            })
    return kernels, served


def serve_routed(index: RoutedSplitIndex, ds, gt) -> dict[str, dict]:
    """All queries through each routed route; returns each route's knobs,
    K4 launches by form and spilled queries, with recall, QPS and coverage
    logged; fails on recall, on a route that launched no K4, and on a
    starved route that spilled nothing."""
    served = {}
    pre = index.preload(ds.queries, batch_size=B)
    probes = rs._auto_probes(index.C)
    for route, knobs in ROUTED_ROUTES:
        T, P = rs._auto_knobs(index.C, probes, knobs.get("tile", 0), knobs.get("shared", 0))
        index.search(ds.queries[:B], 10, batch_size=B, **knobs)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ids, _ = index.search(ds.queries, 10, batch_size=B, preloaded=pre, **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forms = {f"{dt},T{t}": n for (dt, t), n in k4.routed_classmax_scan.form_launches.items()}
        recall = recall_at_k(ids, gt, 10)
        log(f"[routed] {route}: probes={probes} T={T} shared={P} kk={min(80, index.cls)} "
            f"recall@10={recall:.4f} qps={NQ / wall:.1f} wall={wall:.3f} s "
            f"coverage={index.last_coverage:.4f} fallback={index.last_fallback} "
            f"K4 launches={forms}")
        if recall < ROUTED_MIN_RECALL:
            raise AssertionError(f"routed {route}: recall@10 {recall:.4f} < "
                                 f"{ROUTED_MIN_RECALL}")
        if not forms.get(f"int8,T{T}"):
            raise AssertionError(f"routed {route}: K4 at T={T} never launched")
        if route == "starved" and not (index.last_fallback and forms.get("int8,T16")):
            raise AssertionError("routed starved: the fallback spill never ran")
        served[route] = {"T": T, "P": P, "probes": probes, "forms": forms,
                         "spill": index.last_spill.copy(), "recall": recall,
                         "qps": NQ / wall, "coverage": index.last_coverage,
                         "fallback": index.last_fallback}
    return served


@_e2e_timed
def routed_end_to_end(ds, gpu: RoutedSplitIndex) -> None:
    q = ds.queries[:E2E_QUERIES]
    cpu = RoutedSplitIndex(
        *(t.cpu() for t in (gpu.centroids, gpu.comp, gpu.aux_r, gpu.gid)),
        gpu.n, gpu.dim, gpu.metric, cls=gpu.cls, cap=gpu.cap,
        base_dev=gpu.base_dev.cpu(), sqnorms=gpu.sqnorms.cpu())
    t0 = time.perf_counter()
    a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES)
    log(f"[e2e] routed auto on the CPU (twins): {time.perf_counter() - t0:.2f} s")
    b_ids, b_d = gpu.search(q, 10, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, "routed auto", FLAT_ATOL)


def _k4_inputs(index: RoutedSplitIndex, ds, served, dev) -> list[tuple]:
    """(route, T, affinity-sorted queries, cols) of each route's K4 launch:
    the auto and tile=32 routes' first batch, the starved route's spill
    batch (its spilled queries, zero-padded to the spill's bucket)."""
    q_all = torch.from_numpy(ds.queries).to(dev)
    out = []
    for route in ("auto", "tile32", "starved"):
        sv = served[route]
        q, T, P = q_all[:B], sv["T"], sv["P"]
        if route == "starved":
            need = torch.from_numpy(sv["spill"]).to(dev)
            T, P, bucket = rs._spill_plan(len(need), sv["probes"], index.C)
            q = torch.zeros((bucket, D), dtype=torch.float32, device=dev)
            q[:len(need)] = q_all[need]
        perm, _, cols, _, _ = rs.route_batch(index.centroids, q, metric=METRIC_L2,
                                             p=sv["probes"], P=P, T=T, C=index.C)
        out.append((route, T, q[perm], cols))
    return out


def _k4_bound(cols: torch.Tensor, C: int, cap: int, T: int, elt: int, cls: int
              ) -> tuple[float, str, float]:
    """The work the call needs: the bf16 products of each group's T queries
    with the real (not pad) clusters its columns name, at width D; the
    bytes of every cluster the batch is granted read once (rows and their
    nrm and scl), the queries and the outputs. Also the bytes the groups
    read between them (each group its own P blocks)."""
    G, P = cols.shape
    real = int((cols < C).sum())
    uniq = int(torch.unique(cols[cols < C]).numel())
    row_bytes = D * elt + 8
    nbytes = uniq * cap * row_bytes + G * T * D * 2 + G * T * cls * 8 + cols.numel() * 4
    flops = 2.0 * T * real * cap * D
    bms, by = bound_ms(nbytes, flops, PEAK_BF16)
    return bms, by, G * P * cap * row_bytes


def _k4_library_ms(comp, aux_r, q, cols, T: int, cap: int) -> float:
    """The yardstick: a bf16 torch.bmm of each group's queries against its
    gathered (and, for int8, widened) blocks, in chunks of about 1 GB of
    blocks; the gathers are not timed."""
    G, P = cols.shape
    dpc = comp.shape[1]
    comp3 = comp[: aux_r.shape[0] * cap].view(aux_r.shape[0], cap, dpc)
    per = max(1, (1 << 30) // (P * cap * dpc * 2))
    total = 0.0
    for g0 in range(0, G, per):
        c = cols[g0:g0 + per].long()
        blk = comp3[c].view(c.shape[0], P * cap, dpc).to(torch.bfloat16)
        qg = q[g0 * T:(g0 + c.shape[0]) * T].view(c.shape[0], T, dpc)
        total += cuda_ms(lambda: torch.bmm(qg, blk.transpose(1, 2)), reps=3, warmup=1)
        del blk
    return total


def _k4_case(comp, aux_r, q_s, cols, T: int, cap: int, cls: int, what: str,
             timed: bool) -> dict:
    """K4 against its twin on one table and one route's inputs: the score
    error, and rows equal wherever the twin's winner is clear: a lane whose
    row differs must hold a row that scores within K4_ATOL of the twin's
    best. Times kernel, twin and yardstick when ``timed``."""
    q = pack_split_query(q_s, comp.shape[1])
    kw = {"T": T, "cap": cap, "cls": cls}
    best, rows = k4.routed_classmax_scan(comp, aux_r, q, cols, **kw)
    torch.cuda.synchronize()
    want_b, want_r = k4.routed_classmax_scan_ref(comp, aux_r, q, cols, **kw)
    err = float((best - want_b).abs().max())
    if err > K4_ATOL:
        raise AssertionError(f"K4 {what}: scores differ by {err} > {K4_ATOL}")
    differ = rows != want_r
    if bool(differ.any()):
        b_i, l_i = torch.nonzero(differ, as_tuple=True)
        r = rows[b_i, l_i].long()
        g = b_i // T
        trow = cols[g, r // cap].long() * cap + r % cap
        c = cols[g, r // cap].long()
        m = (r % cap) // cls
        members = cap // cls
        dots = (q[b_i].float() * comp[trow].float()).sum(1)
        rescored = aux_r[c, members + m, l_i] * dots + aux_r[c, m, l_i]
        if bool(((want_b[b_i, l_i] - rescored) > K4_ATOL).any()):
            raise AssertionError(f"K4 {what}: rows differ where the twin's "
                                 "winner is clear")
    case = {"what": what, "T": T, "B": int(q.shape[0]), "P": int(cols.shape[1]),
            "max_abs_err": err, "rows_differ": int(differ.sum())}
    msg = f"[K4] {what}: max_abs_err={err:.3e} rows_differ={case['rows_differ']}"
    if timed:
        case["ms"] = cuda_ms(lambda: k4.routed_classmax_scan(comp, aux_r, q, cols, **kw),
                             reps=10)
        case["plain_ms"] = cuda_ms(
            lambda: k4.routed_classmax_scan_ref(comp, aux_r, q, cols, **kw), reps=3,
            warmup=1)
        case["library_ms"] = _k4_library_ms(comp, aux_r, q, cols, T, cap)
        case["bound_ms"], case["bound_by"], case["group_bytes"] = _k4_bound(
            cols, aux_r.shape[0] - 1, cap, T, comp.element_size(), cls)
        msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                f"bmm {case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
                f"({case['bound_by']}), per-group bytes {case['group_bytes'] / 1e9:.3f} GB")
    log(msg)
    return case


def k4_vs_twin(index: RoutedSplitIndex, ds, served, dev) -> dict[tuple, list]:
    """Phase 13: K4 against its twin on every route's inputs, on the int8
    table of the index and on bf16 and IP tables packed in its order."""
    inputs = _k4_inputs(index, ds, served, dev)
    cases: dict[tuple, list] = {}
    for comp_dtype, metric in (("int8", METRIC_L2), ("bf16", METRIC_L2),
                               ("int8", METRIC_IP), ("bf16", METRIC_IP)):
        if (comp_dtype, metric) == ("int8", METRIC_L2):
            comp, aux_r = index.comp, index.aux_r
        else:
            comp, aux_r = rs.pack_clustered(index.base_dev, index.gid, metric,
                                            cap=index.cap, cls=index.cls,
                                            comp_dtype=comp_dtype)
        mname = "l2" if metric == METRIC_L2 else "ip"
        for route, T, q_s, cols in inputs:
            case = _k4_case(comp, aux_r, q_s, cols, T, index.cap, index.cls,
                            f"{comp_dtype} {mname} {route} T={T}",
                            timed=metric == METRIC_L2)
            case.update(comp_dtype=comp_dtype, metric=mname, route=route)
            cases.setdefault((comp_dtype, T), []).append(case)
        del comp, aux_r
        torch.cuda.empty_cache()
    return cases


def _routed_build(base_t) -> tuple[RoutedSplitIndex, float]:
    """The routed build at ROUTED_BUILD, its log lines, and the share of
    rows placed in their first choice (r0) that it reports."""
    lines = []

    def say(m):
        lines.append(m)
        log(f"[routed] {m}")

    t0 = time.perf_counter()
    index = build_routed_split(RN, D, base_dev=base_t, log=say, **ROUTED_BUILD)
    torch.cuda.synchronize()
    log(f"[routed] build on the card: {time.perf_counter() - t0:.2f} s, C={index.C} "
        f"cap={index.cap} comp {tuple(index.comp.shape)} {index.comp.dtype} aux_r "
        f"{tuple(index.aux_r.shape)}")
    r0 = next(float(m.split("r0=")[1].split()[0]) for m in lines if "r0=" in m)
    return index, r0


def routed_rebuild_is_identical(index: RoutedSplitIndex, r0: float, served, base_t,
                                ds) -> None:
    """ROADMAP C9: a second build of the same seed on the card places every
    row as the first did (the k-means sums no longer use float atomics):
    equal r0, equal centroids and layout, and the starved route spills the
    same queries."""
    again, r0_again = _routed_build(base_t)
    again.search(ds.queries, 10, batch_size=B, **dict(ROUTED_ROUTES)["starved"])
    spill, spill_again = served["starved"]["spill"], again.last_spill
    log(f"[routed] C9, two builds of seed {ROUTED_BUILD['seed']}: r0 {r0:.4f} and "
        f"{r0_again:.4f}; starved spill {len(spill)} and {len(spill_again)} queries; "
        f"centroids equal {torch.equal(index.centroids, again.centroids)}, layout equal "
        f"{torch.equal(index.gid, again.gid)}")
    if (r0 != r0_again or not np.array_equal(spill, spill_again)
            or not torch.equal(index.centroids, again.centroids)
            or not torch.equal(index.gid, again.gid)):
        raise AssertionError("C9: two routed builds of one seed differ on the card")
    del again
    torch.cuda.empty_cache()


def routed_phases(dev, routed_ds) -> list[dict]:
    """Phases 12-13 on the 4.19M set (``routed_ds``, its future); K4's
    entries of the kernel table, one a form (int8 table, T), each at the
    route that launched it."""
    t0 = time.perf_counter()
    ds = routed_ds.result()
    log(f"[data] {RN} x {D}, {NQ} queries: ready after waiting "
        f"{time.perf_counter() - t0:.2f} s (made beside phases 6-27)")
    base_t = torch.from_numpy(ds.base).to(dev)
    t0 = time.perf_counter()
    gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
    gt = gt.cpu().numpy()
    log(f"[routed] exact fp32 ground truth on the card: {time.perf_counter() - t0:.2f} s")
    index, r0 = _routed_build(base_t)
    served = serve_routed(index, ds, gt)
    profile_run(lambda: index.search(ds.queries[:B], 10, batch_size=B), "routed auto")
    routed_end_to_end(ds, index)
    routed_rebuild_is_identical(index, r0, served, base_t, ds)
    sharded_routed_phase(index, ds, gt, served, dev)
    cases = k4_vs_twin(index, ds, served, dev)
    kernels = []
    for route in ("auto", "tile32", "starved"):
        T = 16 if route == "starved" else served[route]["T"]
        at = cases[("int8", T)]
        main = next(c for c in at if c["metric"] == "l2")
        kernels.append({
            "name": f"routed_classmax_scan[int8,T{T}]",
            "route": "cuda",
            "source": "shine_tpu_torch/csrc/classmax2_scan.cu",
            "replaces": "shine_tpu/ops/pallas_scan_routed.py:106",
            "launches": served[route]["forms"][f"int8,T{T}"],
            "max_abs_err": max(c["max_abs_err"] for c in at),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "routed_route": route,
            "T": T,
            "B": main["B"],
            "P": main["P"],
            "recall@10": served[route]["recall"],
            "qps": served[route]["qps"],
            "cases": at + cases[("bf16", T)],
        })
    del index, base_t
    torch.cuda.empty_cache()
    return kernels


# --- phases 14-18: K5 and K6, FastFlat's block-max route, the scan-speed build

K56_FORMS = {
    "blockmax_scan": (bm.blockmax_scan, bm.blockmax_scan_ref,
                      "shine_tpu/ops/pallas_scan.py:63",
                      "shine_tpu_torch/csrc/classmax2_scan.cu"),
    "blockmax_scan2": (bm.blockmax_scan2, bm.blockmax_scan2_ref,
                       "shine_tpu/ops/pallas_scan2.py:94",
                       "shine_tpu_torch/csrc/classmax2_scan.cu"),
}
# K5 and K6 score K2's table with K2's products: K2's bound on the sum order
K56_ATOL = K2_ATOL
# the builds on the card: the scan-speed default (pool 0: k = 2M = 32), the
# JAX package's construction-quality parity setting (pool = efc = 200), and
# the block-max sweep; each graph is served as the native one is
BUILDS = (("pool0", {}), ("pool200", {"pool": BUILD.ef_construction}),
          ("blockmax", {"blockmax": True}))
BLOCKMAX_BUILD_GAP = 0.01  # block-max graph's recall against the pool-0 one's
# the CPU-against-card build: Gaussian rows, whose f32 sums differ by ulps
# between the twins and the kernels and reorder a few near ties (the CPU
# tests hold the same to the JAX package)
SMALL_SET = dict(n=8192, dim=16, num_queries=256, seed=21)
SMALL_BUILD = HNSWParams(M=8, ef_construction=50)
SMALL_MIN_OVERLAP, SMALL_RECALL_GAP = 0.95, 0.01


def _int_case(metric: int, n_pad: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The set's shape in integer entries (every score exact in f32): rows
    with ties inside a block and across blocks, the n_pad - N pad rows of
    FastFlat's table, B integer queries."""
    rng = np.random.default_rng(SEED + metric)
    v = rng.integers(-3, 4, size=(N, D)).astype(np.float32)
    v[40:48] = v[39]
    v[QUANTUM + 5] = v[5]
    q = rng.integers(-3, 4, size=(B, D)).astype(np.float32)
    ext = pack_ext_table(v, metric, n_pad, device=dev)
    q_ext = pack_ext_query(torch.from_numpy(q).to(dev), ext.shape[1])
    return ext, q_ext.to(torch.bfloat16)


def _k56_bound(name: str, n_pad: int) -> tuple[float, str]:
    """The work the function needs: the N real rows at width D+2, B queries,
    and every output (K5: four (B, n_pad/128) planes; K6: two (B, n_pad/32))."""
    width = D + 2
    planes, per_col = (4, bm.BLK) if name == "blockmax_scan" else (2, bm.BLK2)
    return scan_bound(N, B, width, width * 2, B * (n_pad // per_col) * planes)


def _rows_near(ext, q, got_rows, want_rows, want_best, what: str) -> int:
    """Rows equal to the twin's, except where the kernel's row scores within
    K56_ATOL of the twin's best (near ties summed in another order).
    Returns how many differ."""
    differ = got_rows != want_rows
    if bool(differ.any()):
        b_i, c_i = torch.nonzero(differ, as_tuple=True)
        r = got_rows[b_i, c_i].long()
        rescored = (q[b_i].float() * ext[r].float()).sum(1)
        if bool(((want_best[b_i, c_i] - rescored).abs() > K56_ATOL).any()):
            raise AssertionError(f"{what}: rows differ where the twin's best is clear")
    return int(differ.sum())


def blockmax_vs_twin(base: np.ndarray, queries: np.ndarray, dev) -> tuple[dict, float]:
    """Phase 14: K5 and K6 against their twins on FastFlat's packed table
    (1,003,520 rows, 3,520 of them pad rows), B=4096, L2 and IP: bit for bit
    on integer entries, to K56_ATOL on the set's rows; timed under L2 with
    the bare bf16 product beside them. Returns each form's cases and the
    yardstick's ms."""
    n_pad = -(-N // QUANTUM) * QUANTUM
    cases: dict[str, list] = {name: [] for name in K56_FORMS}
    library_ms = None
    for metric, mid in (("l2", METRIC_L2), ("ip", METRIC_IP)):
        ext, q = _int_case(mid, n_pad, dev)
        for name, (fn, ref, _, _) in K56_FORMS.items():
            got = fn(ext, q)
            torch.cuda.synchronize()
            want = ref(ext, q)
            if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want)):
                raise AssertionError(f"{name} {metric}: the kernel and the twin differ "
                                     "on the integer table")
            log(f"[K5/K6] {name} {metric}: integer table {tuple(ext.shape)} "
                f"({n_pad - N} pad rows): bit for bit")
            del got, want
        ext = pack_ext_table(base, mid, n_pad, device=dev)
        q = pack_ext_query(torch.from_numpy(queries[:B]).to(dev), ext.shape[1]).to(
            torch.bfloat16)
        for name, (fn, ref, _, _) in K56_FORMS.items():
            got = fn(ext, q)
            torch.cuda.synchronize()
            want = ref(ext, q)
            err = max(float((g - w).abs().max()) for g, w in zip(got[::2], want[::2]))
            if err > K56_ATOL:
                raise AssertionError(f"{name} {metric}: scores differ by {err} > {K56_ATOL}")
            differ = _rows_near(ext, q, got[1], want[1], want[0], name)
            if name == "blockmax_scan":  # runner-ups that entered
                real = want[2] > -3e38
                differ += _rows_near(ext, q, torch.where(real, got[3], want[3]), want[3],
                                     want[2], name)
            case = {"metric": metric, "max_abs_err": err, "rows_differ": differ}
            msg = f"[K5/K6] {name} {metric}: max_abs_err={err:.3e} rows_differ={differ}"
            if metric == "l2":
                case["ms"] = cuda_ms(lambda: fn(ext, q), reps=10)
                case["plain_ms"] = cuda_ms(lambda: ref(ext, q), reps=3, warmup=1)
                case["bound_ms"], case["bound_by"] = _k56_bound(name, n_pad)
                msg += (f" kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
            cases[name].append(case)
            log(msg)
            del got, want
        if metric == "l2":
            def product():
                for lo in range(0, n_pad, 65_536):
                    torch.matmul(q, ext[lo:lo + 65_536].T)
            library_ms = cuda_ms(product, reps=10)
            log(f"[K5/K6] torch.matmul bf16 ({B}, {ext.shape[1]}) x ({n_pad}, "
                f"{ext.shape[1]})^T in 65,536-row chunks: {library_ms:.4f} ms")
        del ext, q
        torch.cuda.empty_cache()
    return cases, library_ms


def serve_blockmax(flat: FastFlatIndex, ds, gt) -> dict:
    """Phase 15: all queries through FastFlat's block-max route (K5, the
    route the JAX package takes under interpret) at the auto kb; recall,
    QPS after a warm-up batch, K5's launches (no class-max launch)."""
    flat.blockmax = True
    pre = flat.preload(ds.queries, batch_size=B)
    flat.search(ds.queries, 10, batch_size=B, preloaded=pre)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = flat.search(ds.queries, 10, batch_size=B, preloaded=pre)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bm.blockmax_scan.launches
    classmax = sum(fn.launches for fn, _, _ in K2_FORMS.values())
    recall = recall_at_k(ids, gt, 10)
    kb = flat._resolve_knobs(0, 0, None, None, False)[0]
    log(f"[flat] blockmax: kb={kb} blocks recall@10={recall:.4f} qps={NQ / wall:.1f} "
        f"wall={wall:.3f} s blockmax_scan launches={launches} class-max launches={classmax}")
    if recall < FLAT_MIN_RECALL:
        raise AssertionError(f"fastflat blockmax: recall@10 {recall:.4f} < {FLAT_MIN_RECALL}")
    if launches == 0 or classmax:
        raise AssertionError(f"fastflat blockmax: {launches} K5 and {classmax} class-max "
                             "launches")
    flat.blockmax = False
    return {"launches": launches, "recall@10": recall, "qps": NQ / wall, "kb": kb}


@_e2e_timed
def blockmax_end_to_end(ds, flat: FastFlatIndex) -> None:
    """Phase 15's end: 256 queries through the block-max route on the CPU
    (twins) against the card."""
    q = ds.queries[:E2E_QUERIES]
    cpu = FastFlatIndex(ds.base, blockmax=True, device="cpu")
    t0 = time.perf_counter()
    a_ids, a_d = cpu.search(q, 10, batch_size=E2E_QUERIES)
    log(f"[e2e] fastflat blockmax on the CPU (twins): {time.perf_counter() - t0:.2f} s")
    flat.blockmax = True
    b_ids, b_d = flat.search(q, 10, batch_size=E2E_QUERIES)
    flat.blockmax = False
    _compare(a_ids, a_d, b_ids, b_d, "fastflat blockmax", FLAT_ATOL)


def _stage_line(timings: dict) -> str:
    parts = []
    for lv in timings["levels"]:
        stages = " ".join(f"{k}={v:.2f}" for k, v in lv.items() if k != "n")
        parts.append(f"n={lv['n']}: {stages}")
    return "; ".join(parts)


def build_phases(ds, gt, dev) -> dict:
    """Phases 16-17: fast_build_graph on the card at 1M, M=16, the rows
    resident: pool 0 and pool 200 through the class-max sweep, then the
    block-max sweep (K5); each build's stage times, the sweep's plan and its
    kernel launches, then its graph served as the native one is."""
    base_t = torch.from_numpy(ds.base).to(dev)
    out = {}
    for name, kw in BUILDS:
        torch.cuda.synchronize()
        reset_launches()
        t = {}
        t0 = time.perf_counter()
        graph = fast_build_graph(ds.base, BUILD, base_dev=base_t, timings=t, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: fn.launches for n, (fn, _, _) in K2_FORMS.items()}
        counts.update({n: fn.launches for n, (fn, _, _, _) in K56_FORMS.items()})
        counts = {k: v for k, v in counts.items() if v}
        plan = t["plan"]
        log(f"[build] {name}: {wall:.2f} s (stages {t['total']:.2f} s), "
            f"top_level={graph.top_level}, upper vertices={int((graph.levels > 0).sum())}")
        budget = "none" if plan["budget"] is None else f"{plan['budget'] / 1e9:.2f} GB"
        log(f"[build]   sweep plan: layout={plan['layout']} batch={plan['batch']} "
            f"kb={plan['kb']} keep2={plan['keep2']} cls={plan['cls']} planned "
            f"{plan['total'] / 1e9:.3f} GB, budget {budget}")
        log(f"[build]   stage seconds: {_stage_line(t)}; components="
            f"{t['components']:.2f}; upper levels={t['upper_levels']:.2f}")
        log(f"[build]   kernel launches in the build: {counts}")
        sweep = "blockmax_scan" if kw.get("blockmax") else "classmax2_scan"
        if counts.get(sweep, 0) < N // plan["batch"]:
            raise AssertionError(f"build {name}: {sweep} launched "
                                 f"{counts.get(sweep, 0)} times for the sweep")
        _, recall, qps = serve(graph, ds, gt, "f32", dev, what=f"fast_build {name}")
        out[name] = {"seconds": wall, "timings": {
            "levels": t["levels"], "components": t["components"],
            "upper_levels": t["upper_levels"]},
            "plan": {k: v for k, v in plan.items()}, "launches": counts,
            "recall@10": recall, "qps": qps}
        del graph
        torch.cuda.empty_cache()
    gap = abs(out["blockmax"]["recall@10"] - out["pool0"]["recall@10"])
    log(f"[build] block-max graph against the pool-0 graph: recall gap {gap:.4f} "
        f"(stated {BLOCKMAX_BUILD_GAP})")
    if gap > BLOCKMAX_BUILD_GAP:
        raise AssertionError(f"block-max build: recall {out['blockmax']['recall@10']:.4f}"
                             f" against {out['pool0']['recall@10']:.4f}")
    del base_t
    torch.cuda.empty_cache()
    return out


def small_build_cpu_vs_card(dev) -> None:
    """Phase 18: the same build at 8192 x 16 on the CPU (twins) and on the
    card: equal levels and entry point, overlapping layer-0 lists, and the
    same recall of 256 queries served from each."""
    small = synthetic_dataset(**SMALL_SET)
    base = torch.from_numpy(small.base)
    cpu = fast_build_graph(small.base, SMALL_BUILD, base_dev=base)
    gpu = fast_build_graph(small.base, SMALL_BUILD, base_dev=base.to(dev))
    if not np.array_equal(cpu.levels, gpu.levels) or cpu.entry_point != gpu.entry_point:
        raise AssertionError("small build: levels or entry point differ CPU/card")
    hits = sum(np.intersect1d(a[a >= 0], b[b >= 0]).size
               for a, b in zip(cpu.neighbors0, gpu.neighbors0))
    overlap = hits / max(int((cpu.neighbors0 >= 0).sum()), 1)
    recalls = []
    for g in (cpu, gpu):
        ids, _ = HNSWIndex(g, device=dev).search(
            small.queries, SearchParams(k=10, ef=64), batch_size=256)
        recalls.append(recall_at_k(ids, small.ground_truth, 10))
    log(f"[e2e] fast_build 8192 x 16, CPU against card: levels and entry equal, "
        f"layer-0 overlap {overlap:.4f} (stated {SMALL_MIN_OVERLAP}), recall@10 "
        f"{recalls[0]:.4f} and {recalls[1]:.4f}, identical lists "
        f"{np.array_equal(cpu.neighbors0, gpu.neighbors0)}")
    if overlap < SMALL_MIN_OVERLAP or abs(recalls[0] - recalls[1]) > SMALL_RECALL_GAP:
        raise AssertionError("small build: the CPU and card graphs differ too much")


# --- phases 20-21: the insert build on the card and the online index --------

# phase 20: device_build_graph at its defaults (batch_size=512, first_batch=32,
# level_cap=12) and BUILD, on the first DEVBUILD_N rows of the set
DEVBUILD_N = N
# the JAX package's own parity bound for this build against the native one
# (tests/test_build.py:test_device_build_parity_with_native)
DEVBUILD_GAP = 0.02
DET_N = 65_536  # two builds of these rows must be bit-identical
DET_GRAPH: dict = {}  # phase 20's build of DET_N rows, for phase 27a
# the CPU-against-card build: integer entries, every distance exact, so the
# twins and the kernels build the same graph
INT_BUILD_SET = dict(n=4096, d=16, seed=13)
INT_BUILD = HNSWParams(M=8, ef_construction=40)
# phase 21: the online index, fed ONLINE_CHUNKS chunks of the set's rows
# chunks of ONLINE_CHUNK rows into an index of ONLINE_CAP (four chunks, the
# index full, until the script passed 1,050 s on a slow host)
ONLINE_CAP, ONLINE_CHUNK, ONLINE_CHUNKS = 262_144, 65_536, 2
ONLINE_MIN_RECALL = 0.90
ONLINE_STEP_CHECK = 2  # the build's beam_step is checked after this chunk
GRAPH_FIELDS = ("levels", "neighbors0", "upper_row", "upper_neighbors")


def _launches() -> dict[str, int]:
    return {"beam_step": bs.beam_step.launches, "gather_score": gather_score.launches}


def _same_graph(a, b, what: str) -> None:
    """Fail unless two GraphSoA hold the same lists, levels and entry."""
    diff = [f for f in GRAPH_FIELDS if not np.array_equal(getattr(a, f), getattr(b, f))]
    if diff or (a.entry_point, a.top_level) != (b.entry_point, b.top_level):
        raise AssertionError(f"{what}: the graphs differ in {diff or 'the entry point'}")


def device_build_phase(ds, gt, dev) -> dict:
    """Phase 20: device_build_graph on the card at full width, its stage
    seconds and launches, its graph served as the native one is (held to
    the native graph's recall by devbuild_parity, once that graph is
    built); two builds of DET_N rows bit-identical."""
    n = DEVBUILD_N
    torch.cuda.synchronize()
    reset_launches()
    t = {}
    t0 = time.perf_counter()
    graph = device_build_graph(ds.base[:n], BUILD, device=dev, timings=t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    stages = {k: t.get(k, 0.0) for k in tb.STAGES}
    log(f"[devbuild] {n} x {D} M={BUILD.M} efc={BUILD.ef_construction}: {wall:.2f} s, "
        f"{t['rounds']} rounds, {n / wall:.1f} inserts/s, top_level={graph.top_level}, "
        f"upper vertices={int((graph.levels > 0).sum())}")
    log("[devbuild]   stage seconds: " + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
        + f"; other (host, the rounds' bookkeeping) {wall - sum(stages.values()):.3f}")
    log(f"[devbuild]   kernel launches in the build: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"device build: a kernel of the path never launched: {launches}")
    graph.validate()
    if n < N:
        base_t = torch.from_numpy(ds.base[:n]).to(dev)
        gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
        gt = gt.cpu().numpy()
        del base_t
    _, recall, qps = serve(graph, ds, gt, "f32", dev, what=f"device_build {n}")
    del graph
    torch.cuda.empty_cache()
    twice, det_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        twice.append(device_build_graph(ds.base[:DET_N], BUILD, device=dev))
        torch.cuda.synchronize()
        det_s.append(time.perf_counter() - t0)
    _same_graph(*twice, f"two device builds of {DET_N} rows")
    DET_GRAPH["single"], DET_GRAPH["seconds"] = twice[0], det_s
    log(f"[devbuild] two builds of the first {DET_N} rows ({det_s[0]:.2f} s and "
        f"{det_s[1]:.2f} s): levels, lists and entry point bit-identical")
    return {"n": n, "seconds": wall, "rounds": t["rounds"], "inserts_per_s": n / wall,
            "stages": stages, "launches": launches, "recall@10": recall, "qps": qps}


def int_build_cpu_vs_card(dev) -> None:
    """Phase 20's end: the integer build on the CPU (twins) and the card."""
    rows = np.random.default_rng(INT_BUILD_SET["seed"]).integers(
        -4, 5, size=(INT_BUILD_SET["n"], INT_BUILD_SET["d"])).astype(np.float32)
    t0 = time.perf_counter()
    _same_graph(device_build_graph(rows, INT_BUILD, device="cpu"),
                device_build_graph(rows, INT_BUILD, device=dev),
                "integer build, CPU against card")
    log(f"[devbuild] integer build {rows.shape[0]} x {rows.shape[1]} M={INT_BUILD.M}: "
        f"equal on the CPU (twins) and on the card ({time.perf_counter() - t0:.2f} s)")


def devbuild_parity(devbuild: dict, native_recall: float) -> None:
    """Phase 20's graph against the native graph of the same rows."""
    recall = devbuild["recall@10"]
    log(f"[devbuild] recall@10 {recall:.4f} against the native graph's "
        f"{native_recall:.4f} (stated gap {DEVBUILD_GAP})")
    if recall < native_recall - DEVBUILD_GAP:
        raise AssertionError(f"device build: recall@10 {recall:.4f} more than "
                             f"{DEVBUILD_GAP} below the native {native_recall:.4f}")


def build_step_check(st, rows: np.ndarray, ef: int, B_up: int, dev) -> list[dict]:
    """The build's searches on the state ``st`` for its next batch (the
    ids from ``st.count`` on, rows ``rows``), seeded by the greedy descent
    as a round seeds them: layer 0 for the whole batch over ``neighbors0``,
    and level 1 for the upper sub-batch of ``B_up`` slots (the batch's
    upper nodes, lowest ids first, -1 elsewhere, as ``plan_round`` forms
    it) over the level's (N, M) list table. On each, beam_step against
    beam_step_ref bit for bit after every step, then one step timed with
    its bound (step_timing). Returns the two cases."""
    q = torch.from_numpy(rows).to(dev)
    q_ext, bias = (-2.0 * q).contiguous(), squared_norms(q)
    nq = len(q)
    sp = SearchParams(k=ef, ef=ef, frontier=4, max_steps=2 * -(-ef // 4) + 8,
                      term="ef")
    # a level-1 node's descent walks the levels above 1 and seeds its
    # level-1 search; a layer-0 node's walks level 1 too and seeds layer 0
    ep1, ep1_d = tb._greedy_to_level(st, q_ext, bias, torch.ones(
        nq, dtype=torch.int32, device=dev), True)
    ep0, ep0_d = tb._greedy_to_level(st, q_ext, bias, torch.zeros(
        nq, dtype=torch.int32, device=dev), True)
    ids = torch.arange(st.count, st.count + nq, dtype=torch.int32, device=dev)
    is_up = st.levels[ids.long()] >= 1
    pos = torch.argsort(torch.where(is_up, ids, tb.INT32_MAX), stable=True)[:B_up]
    up_ok = is_up[pos]
    searches = (
        (0, q_ext, bias, ep0, ep0_d),
        (1, q_ext[pos].contiguous(), bias[pos].contiguous(),
         torch.where(up_ok, ep1[pos], -1), ep1_d[pos]),
    )
    cases = []
    for level, qe, b, ep, ep_d in searches:
        g = SimpleNamespace(vectors_ext=st.vectors, neighbors0=tb._level_lists(st, level),
                            row_scl=None, row_nrm=None)

        def seeded() -> list:
            return list(th._l0_state(ep[:, None].contiguous(), ep_d[:, None].contiguous(),
                                     sp))

        what = f"build level {level}"
        steps, entries = step_vs_twin(g, qe, b, seeded(), sp, what)
        log(f"[K1] beam_step on the build state after {st.count} inserts, level "
            f"{level} ({len(qe)} queries, {int(up_ok.sum()) if level else nq} taking "
            f"part, lists {tuple(g.neighbors0.shape)}): equal to beam_step_ref bit for "
            f"bit after each of the {steps} steps ({entries} beam entries)")
        case = step_timing(g, qe, b, seeded(), sp, f"{what}, {st.count} inserted")
        case.update(max_abs_err=0.0, search_steps_compared=steps, inserted=st.count,
                    level=level)
        cases.append(case)
    return cases


def online_phase(ds, dev) -> tuple[dict, list[dict]]:
    """Phase 21: DynamicHNSWIndex of capacity ONLINE_CAP fed the set's first
    ONLINE_CHUNKS chunks of ONLINE_CHUNK rows; after each chunk its searcher
    serves the queries against the exact top-10 of the inserted prefix (on
    the card). After chunk ONLINE_STEP_CHECK the build's layer-0 and level-1
    searches are checked on its state (build_step_check). Returns (the
    phase's record, that check's two cases)."""
    chunk = ONLINE_CHUNK
    index = DynamicHNSWIndex(D, capacity=ONLINE_CAP, params=BUILD, device=dev)
    base_t = torch.from_numpy(ds.base[:chunk * ONLINE_CHUNKS]).to(dev)
    q_t = torch.from_numpy(ds.queries).to(dev)
    chunks, launches, step_cases = [], {"beam_step": 0, "gather_score": 0}, []
    for i in range(ONLINE_CHUNKS):
        lo = i * chunk
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        index.add(ds.base[lo : lo + chunk])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        added = _launches()
        for k in launches:
            launches[k] += added[k]
        gt, _ = exact_knn(base_t[: lo + chunk], q_t, 10)
        searcher = index.searcher()
        ids, _ = searcher.search(ds.queries, SEARCH, batch_size=B)
        recall = recall_at_k(ids, gt.cpu().numpy(), 10)
        log(f"[online] chunk {i + 1}: {chunk} inserts in {sec:.2f} s ({chunk / sec:.1f} "
            f"inserts/s), {index.count} in the index, launches {added}; searcher "
            f"recall@10 {recall:.4f} against the exact top-10 of the prefix")
        chunks.append({"inserted": index.count, "seconds": sec,
                       "inserts_per_s": chunk / sec, "recall@10": recall,
                       "launches": added})
        if recall < ONLINE_MIN_RECALL:
            raise AssertionError(f"online index: recall@10 {recall:.4f} < "
                                 f"{ONLINE_MIN_RECALL} after {index.count} inserts")
        if min(added.values()) == 0:
            raise AssertionError(f"online index: a kernel never launched: {added}")
        if i + 1 == ONLINE_STEP_CHECK:
            B_up = -(-tb.upper_batch(index.batch_size, BUILD.M) // 8) * 8
            step_cases = build_step_check(
                index.st, ds.base[index.count : index.count + index.batch_size],
                BUILD.ef_construction, B_up, dev)
        del searcher
    del index, base_t
    torch.cuda.empty_cache()
    return {"chunks": chunks, "launches": launches}, step_cases


# --- phase 23: the IVF family at full width --------------------------------------

IVF_SEED = 1234
IVF_PROBES = (16, 32, 64)  # search on the fine layout: recall must not fall
IVF_E2E_PROBES = 32  # the CPU-against-card check and the probe-chunk identity
IVF_PROBE_CHUNK = 4
# full probes: the set's first IVF_FULL_N rows in IVF_FULL_C clusters, every
# cluster probed, must find the exact top-10 (the JAX package's
# test_ivf_search_exact_full_probes_large_c on the chunked path)
IVF_FULL_N, IVF_FULL_C, IVF_FULL_QUERIES, IVF_FULL_MIN_RECALL = 65_536, 512, 1_000, 0.99
# search_routed: the command line's defaults and bench.py's point
IVF_ROUTES = (("cli", {"probes": 16, "shared": 96, "tile": 256}),
              ("bench", {"probes": 16, "shared": 128, "tile": 64}))
IVF_DEVICE_RECALL_GAP = 0.02  # from_device draws other samples, same semantics


def _ivf_layout_check(index: IVFIndex, n: int, what: str, C: int | None = None) -> None:
    """The auto cluster count (C, default the fine layout's ceil(n/128)) and
    cap = ceil(1.25 n / C); every id exactly once, no cluster over cap, pads
    -1 with +inf norms and zero rows (on the card)."""
    data = index.data
    C = C or -(-n // 128)
    if (data.num_clusters, data.cap) != (C, math.ceil(1.25 * n / C)):
        raise AssertionError(f"ivf {what}: C={data.num_clusters} cap={data.cap}")
    ids = data.block_ids
    real = ids >= 0
    every_once = torch.equal(torch.sort(ids[real]).values,
                             torch.arange(n, dtype=ids.dtype, device=ids.device))
    per = int(real.sum(dim=1).max())
    pads_ok = bool(torch.isinf(data.block_sq[~real]).all()
                   and (data.blocks[~real] == 0).all()
                   and torch.isfinite(data.block_sq[real]).all())
    log(f"[ivf] {what}: C={data.num_clusters} cap={data.cap} fullest cluster {per}, "
        f"every id once {every_once}, pads -1/+inf/zero {pads_ok}")
    if not (every_once and per <= data.cap and pads_ok):
        raise AssertionError(f"ivf {what}: layout invariants broken")


def _ivf_timed(run) -> tuple[tuple, float]:
    """(``run()``'s result, its CUDA-synchronised seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ivf_build(what: str, build) -> tuple[IVFIndex, dict]:
    timings = {}
    index, wall = _ivf_timed(lambda: build(timings))
    log(f"[ivf] {what}: {wall:.2f} s, stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items()))
    return index, {"seconds": wall, "stages": timings, "C": index.data.num_clusters,
                   "cap": index.data.cap}


def _ivf_search(index: IVFIndex, ds, gt, probes: int, what: str) -> dict:
    """All queries at batch B after a warm-up batch: recall@10 and QPS."""
    index.search(ds.queries[:B], 10, probes=probes, batch_size=B)
    (ids, _), wall = _ivf_timed(
        lambda: index.search(ds.queries, 10, probes=probes, batch_size=B))
    recall = recall_at_k(ids, gt, 10)
    log(f"[ivf] {what} search probes={probes}: recall@10={recall:.4f} "
        f"qps={NQ / wall:.1f} wall={wall:.3f} s")
    return {"recall": recall, "qps": NQ / wall}


def _ivf_routed(index: IVFIndex, ds, gt, knobs: dict, what: str) -> dict:
    index.search_routed(ds.queries[:B], 10, **knobs)
    (ids, _, st), wall = _ivf_timed(
        lambda: index.search_routed(ds.queries, 10, with_stats=True, **knobs))
    recall = recall_at_k(ids, gt, 10)
    log(f"[ivf] {what} search_routed {knobs}: recall@10={recall:.4f} "
        f"qps={NQ / wall:.1f} wall={wall:.3f} s coverage={st['probe_coverage']:.4f} "
        f"spilled={st['fallback_queries']} tiles={st['tiles']}")
    return {"recall": recall, "qps": NQ / wall, "coverage": st["probe_coverage"],
            "spilled": st["fallback_queries"]}


def ivf_phase(ds, gt, dev) -> dict:
    """Phase 23: IVFIndex on the 1M set, built on the host (fine and routed
    layouts) and on the card (from_device); every check raises. Returns
    the numbers the [ivf] summary line carries."""
    t_phase = time.perf_counter()
    out = {}
    fine, out["fine_build"] = _ivf_build("fine layout, host build", lambda tm: IVFIndex(
        ds.base, seed=IVF_SEED, device=dev, timings=tm))
    _ivf_layout_check(fine, N, "fine layout")
    served = {p: _ivf_search(fine, ds, gt, p, "fine") for p in IVF_PROBES}
    recalls = [served[p]["recall"] for p in IVF_PROBES]
    if recalls != sorted(recalls):
        raise AssertionError(f"ivf fine: recall falls as probes rise: {recalls}")
    out["fine"] = served

    # the card against the CPU on the same layout; the probe chunk's identity
    q = ds.queries[:E2E_QUERIES]
    t_e2e = time.perf_counter()
    cpu = IVFIndex.from_layout(IVFData(*(t.cpu() for t in fine.data)), "l2")
    a_ids, a_d = cpu.search(q, 10, probes=IVF_E2E_PROBES, batch_size=E2E_QUERIES)
    b_ids, b_d = fine.search(q, 10, probes=IVF_E2E_PROBES, batch_size=E2E_QUERIES)
    _compare(a_ids, a_d, b_ids, b_d, f"ivf fine probes={IVF_E2E_PROBES}", FLAT_ATOL)
    E2E_SECONDS.append(time.perf_counter() - t_e2e)
    del cpu
    q_dev = torch.from_numpy(ds.queries[:B]).to(dev)
    kw = dict(k=10, p=IVF_E2E_PROBES, metric=METRIC_L2)
    a, b = (ivf_search(fine.data, q_dev, **kw),
            ivf_search(fine.data, q_dev, probe_chunk=IVF_PROBE_CHUNK, **kw))
    same = torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32),
                                                   b[1].view(torch.int32))
    log(f"[ivf] probe_chunk={IVF_PROBE_CHUNK} against the default chunk, probes="
        f"{IVF_E2E_PROBES}, one batch of {B}: bit for bit {same}")
    if not same:
        raise AssertionError("ivf: the probe chunk changed the results")
    del q_dev, a, b

    # what --index ivf --ivf-routed serves: search_routed on the fine layout
    out["fine_routed_cli"] = _ivf_routed(fine, ds, gt, dict(IVF_ROUTES)["cli"],
                                         "fine layout")
    profile_run(lambda: fine.search(ds.queries[:B], 10, probes=IVF_E2E_PROBES,
                                    batch_size=B), f"ivf search probes={IVF_E2E_PROBES}")
    fine_recall32 = served[IVF_E2E_PROBES]["recall"]
    del fine
    torch.cuda.empty_cache()

    # full probes scan everything: the exact top-10 of a subset
    sub = ds.base[:IVF_FULL_N]
    qf = ds.queries[:IVF_FULL_QUERIES]
    sub_gt = exact_knn(torch.from_numpy(sub).to(dev), torch.from_numpy(qf).to(dev),
                       10)[0].cpu().numpy()
    full, _ = _ivf_build(f"{IVF_FULL_N} rows, C={IVF_FULL_C}", lambda tm: IVFIndex(
        sub, num_clusters=IVF_FULL_C, seed=IVF_SEED, device=dev, timings=tm))
    (ids, _), wall = _ivf_timed(lambda: full.search(qf, 10, probes=IVF_FULL_C, rerank=8))
    out["full_probes_recall"] = recall_at_k(ids, sub_gt, 10)
    log(f"[ivf] full probes ({IVF_FULL_C} of {IVF_FULL_C}, rerank 8, "
        f"{IVF_FULL_QUERIES} queries): recall@10={out['full_probes_recall']:.4f} "
        f"wall={wall:.3f} s")
    if out["full_probes_recall"] < IVF_FULL_MIN_RECALL:
        raise AssertionError(f"ivf full probes: recall {out['full_probes_recall']}")
    del full

    # the routed layout (C <= 2048)
    routed, out["routed_build"] = _ivf_build("routed layout, host build", lambda tm: IVFIndex(
        ds.base, seed=IVF_SEED, layout="routed", device=dev, timings=tm))
    _ivf_layout_check(routed, N, "routed layout", min(2048, -(-N // 128)))
    out["routed"] = {r: _ivf_routed(routed, ds, gt, knobs, "routed layout")
                     for r, knobs in IVF_ROUTES}
    per_query = routed.search(ds.queries, 10, probes=16)
    spilled = routed.search_routed(ds.queries, 10, probes=16, shared=96, tile=256,
                                   fallback=1.1, with_stats=True)
    same = np.array_equal(spilled[0], per_query[0])
    log(f"[ivf] routed layout, fallback=1.1 ({spilled[2]['fallback_queries']} spilled) "
        f"against search probes=16: ids equal {same} (in "
        f"{(spilled[0] == per_query[0]).mean():.6f} of positions), dists bit for bit "
        f"{np.array_equal(spilled[1].view(np.uint32), per_query[1].view(np.uint32))}")
    if not same or spilled[2]["fallback_queries"] != NQ:
        raise AssertionError("ivf: the fallback spill is not the per-query search")
    profile_run(lambda: routed.search_routed(ds.queries[:B], 10, **dict(IVF_ROUTES)["cli"]),
                "ivf search_routed, routed layout, the CLI's knobs")
    del routed, per_query, spilled
    torch.cuda.empty_cache()

    # the build that keeps the rows on the card
    v_dev = torch.from_numpy(ds.base).to(dev)
    on_card, out["device_build"] = _ivf_build("fine layout, from_device", lambda tm: (
        IVFIndex.from_device(v_dev, seed=IVF_SEED, device=dev, timings=tm)))
    _ivf_layout_check(on_card, N, "from_device")
    out["device"] = _ivf_search(on_card, ds, gt, IVF_E2E_PROBES, "from_device")
    if abs(out["device"]["recall"] - fine_recall32) > IVF_DEVICE_RECALL_GAP:
        raise AssertionError(f"ivf from_device: recall {out['device']['recall']} "
                             f"against the host build's {fine_recall32}")
    del on_card, v_dev
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[ivf] phase 23: {out['seconds']:.1f} s")
    log(f"[ivf] summary {json.dumps(out)}")
    return out


# --- phase 22: the command line at full width ----------------------------------

# the runs' shared flags, and the HNSW ones: phase 5's build and search
CLI_COMMON = ["-k", "10", "--batch", str(B)]
CLI_HNSW = ["-m", str(BUILD.M), "--ef-construction", str(BUILD.ef_construction),
            "--ef-search", str(SEARCH.ef), "--frontier", str(SEARCH.frontier)]
CLI_MIN_RECALL = 0.90  # split, routed, the device build: broken, not mistuned
CLI_FLAT_QUERIES = 1_000
CLI_DEVBUILD = ["--synthetic", "65536:128", "--num-queries", "1000"]
CLI_DEVBUILD_GRAPH = "devbuild_65536.npz"  # phase 22 stores it for phase 27d
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def _all_launches() -> dict[str, int]:
    """Each kernel wrapper's launches since reset_launches, those above 0."""
    counts = {"gather_score": gather_score.launches,
              "beam_step": bs.beam_step.launches,
              "routed_classmax_scan": k4.routed_classmax_scan.launches}
    for forms in (K2_FORMS, K3_FUNCS, K56_FORMS):
        counts.update({name: f[0].launches for name, f in forms.items()})
    return {k: v for k, v in counts.items() if v}


def run_cli(argv: list[str], what: str) -> tuple[dict, dict, str]:
    """``shine_tpu_torch.cli.main(argv)`` in this process, its output
    captured: (the Statistics document of its last stdout line, each
    kernel's launches during the run, its stderr); logs one [cli] line."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = _all_launches()
    if rc != 0:
        raise AssertionError(f"cli {what}: exit status {rc}: {err.getvalue()}")
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    q = doc["queries"]
    log(f"[cli] {what}: build_ms={doc['build']['build_time_ms']} "
        f"qps={q['queries_per_sec']} recall={q['recall']} "
        f"queries={q['num_queries']} expansions={q['expansions']} "
        f"distance_computations={q['distance_computations']} "
        f"scanned_rows={q['scanned_rows']} steps={q['traversal_steps']} "
        f"hbm_gather_bytes={q['hbm_gather_bytes']} timings={doc['timings']} "
        f"device={doc['meta']['device']!r} launches={launches} wall={wall:.2f} s")
    torch.cuda.empty_cache()
    return doc, launches, err.getvalue()


def _library_flat(ds, gt, dev) -> tuple[float, float]:
    """The port's FlatIndex on the first CLI_FLAT_QUERIES queries, as the
    CLI's flat run serves them: (recall@10, QPS after a warm-up pass)."""
    index = FlatIndex(ds.base, device=dev)
    q = ds.queries[:CLI_FLAT_QUERIES]
    index.search(q, 10, batch_size=B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _ = index.search(q, 10, batch_size=B)
    torch.cuda.synchronize()
    qps = CLI_FLAT_QUERIES / (time.perf_counter() - t0)
    del index
    torch.cuda.empty_cache()
    return recall_at_k(ids, gt[:CLI_FLAT_QUERIES], 10), qps


def cli_phase(ds, gt, graph_path: str, data_dir: str, want: dict, dev) -> dict:
    """Phase 22: the command line, in process, from the set and phase 5's
    graph saved under ``data_dir`` and at ``graph_path``. ``want`` maps a
    run to (its recall rule, the library run's QPS at the same knobs, that
    run's phase): ("eq", r) asks for recall r exactly, ("ge", r) for at
    least r. Each run must launch its kernels. Returns each run's
    numbers."""
    t_phase = time.perf_counter()
    flat_recall, flat_qps = _library_flat(ds, gt, dev)
    want = dict(want, flat=(("eq", flat_recall), flat_qps, "22, FlatIndex.search"))
    data = ["--data-path", data_dir, *CLI_COMMON]
    runs = (  # (name, argv, kernels that must launch)
        ("hnsw", data + ["--index", "hnsw", "--load-index", graph_path, *CLI_HNSW],
         ("beam_step",)),
        ("hnsw_scan_build", data + ["--index", "hnsw", "--fast-build", *CLI_HNSW],
         ("classmax2_scan",)),
        ("fastflat", data + ["--index", "fastflat"], ("classmax_scan",)),
        ("split", data + ["--index", "split"], ("classmax_scan_split",)),
        ("routed", data + ["--index", "routed", "--probes", "0"],
         ("routed_classmax_scan",)),
        ("auto_zipf", data + ["--index", "auto", "--zipf", "1.0", "--warmup", "1000"],
         ("classmax_scan",)),
        ("flat", data + ["--index", "flat", "--num-queries", str(CLI_FLAT_QUERIES)],
         ()),
        ("hnsw_device_build", CLI_DEVBUILD + CLI_COMMON
         + ["--index", "hnsw", "--device-build", *CLI_HNSW, "--store-index",
            os.path.join(os.path.dirname(graph_path), CLI_DEVBUILD_GRAPH)],
         ("beam_step", "gather_score")),
        ("ivf", data + ["--index", "ivf", "--probes", str(IVF_E2E_PROBES),
                        "--seed", str(IVF_SEED)], ("gather_score",)),
        ("ivf_routed", data + ["--index", "ivf", "--ivf-routed", "--seed",
                               str(IVF_SEED)], ("gather_score",)),
    )
    out = {}
    for name, argv, kernels in runs:
        doc, launches, err = run_cli(argv, name)
        q = doc["queries"]
        rule, lib_qps, lib_phase = want[name]
        if lib_qps is not None:
            log(f"[cli]   {name}: {q['queries_per_sec']:.1f} QPS against "
                f"{lib_qps:.1f} for the library call at the same knobs (phase "
                f"{lib_phase}): {q['queries_per_sec'] / lib_qps:.3f}x")
        kind, value = rule
        ok = q["recall"] == value if kind == "eq" else q["recall"] >= value
        if not ok:
            raise AssertionError(f"cli {name}: recall@10 {q['recall']} against "
                                 f"{kind} {value}")
        missing = [k for k in kernels if not launches.get(k)]
        if missing:
            raise AssertionError(f"cli {name}: {missing} never launched")
        if name.startswith("ivf") and set(launches) - {"gather_score"}:
            raise AssertionError(f"cli {name}: IVF launched {launches}")
        if name == "auto_zipf" and "-> fastflat" not in err:
            raise AssertionError(f"cli auto: resolved otherwise: {err.strip()}")
        out[name] = {"argv": argv, "build": doc["build"], "queries": q,
                     "timings": doc["timings"], "launches": launches,
                     "library_qps": lib_qps}
    log(f"[cli] phase 22: {time.perf_counter() - t_phase:.1f} s")
    log(f"[cli] summary {json.dumps(out)}")
    return out


# --- phase 25: the sharded HNSW serving path ------------------------------------

SHARD_CACHE = int(cli.CACHE_RATIO * N)  # the CLI's --cache: 100,000 vertices
# (name, shards, ShardedIndex kwargs, SearchParams kwargs); every f32 route
# must give dense_s4's ids and distance bits
SHARD_ROUTES = (
    ("dense_s4", 4, {}, {}),
    ("dense_s8", 8, {}, {}),
    ("compact_s8", 8, {}, {"exchange": "compact"}),
    ("compact_s8_ladder", 8, {}, {"exchange": "compact", "adaptive_slack": True}),
    ("bf16_s4", 4, {"rows": "bf16"}, {}),
    ("cache_s8", 8, {"cache_capacity": SHARD_CACHE}, {}),
    ("adaptive_cache_s8", 8, {"cache_capacity": SHARD_CACHE, "adaptive_cache": True},
     {}),
    ("routing_s4", 4, {"routing": True}, {}),
    ("adaptive_routing_s4", 4, {"routing": "adaptive"}, {}),
)
# one batch of 4096 after the warm-up batch (the ladder and adaptive routing
# see the second): cut from 10,000, then from two batches, when the whole
# script passed 1,050 s on a slow host
SHARD_QUERIES = B
SHARD_MIN_AGREE = 0.999  # ids against the single-card index (tests/test_sharded.py)
SHARD_INT = (65_536, 16)  # the integer-row graph served on a card and a CPU mesh
SHARD_INT_QUERIES = 256
SHARD_COUNTERS = ("cache_hits", "cache_misses", "rpc_rounds", "ici_lanes",
                  "ici_bytes", "readbacks", "batches", "last_hops")


def _zero_counters(index: ShardedIndex) -> None:
    for c in SHARD_COUNTERS:
        setattr(index, c, 0)


def _serve_sharded(graph, ds, gt, dev, name: str, S: int, kw: dict, spkw: dict
                   ) -> tuple[dict, np.ndarray, np.ndarray]:
    """One route: the index on S shards stacked on the card, a warm-up pass
    (``warm`` for the adaptive cache, else one batch), then every query
    timed. Returns (the route's numbers, ids, distances)."""
    t0 = time.perf_counter()
    index = ShardedIndex(graph, shard_mesh(S, device=dev), **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sp = SearchParams(k=SEARCH.k, ef=SEARCH.ef, frontier=SEARCH.frontier, **spkw)
    q = ds.queries[:SHARD_QUERIES]
    if kw.get("adaptive_cache"):
        index.warm(q, sp, batch_size=B)
    else:
        index.search(q[:B], sp, batch_size=B)
    torch.cuda.synchronize()
    _zero_counters(index)
    reset_launches()
    t0 = time.perf_counter()
    ids, dd = index.search(q, sp, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_launches()
    nq = len(q)
    looked = index.cache_hits + index.cache_misses
    out = {
        "shards": S, "index": {k: v for k, v in kw.items()}, "search": spkw,
        "recall@10": recall_at_k(ids, gt[:nq], 10), "qps": nq / wall,
        "wall_s": wall, "setup_s": setup_s,
        "gather_score_launches": launches.get("gather_score", 0),
        "hit_rate": index.cache_hits / looked if looked else 0.0,
        "rpc_rounds": index.rpc_rounds, "ici_lanes_per_query": index.ici_lanes / nq,
        "ici_bytes_per_query": index.ici_bytes / nq,
        "readbacks_per_batch": index.readbacks / index.batches,
        "batches": index.batches, "mean_hops": index.last_hops / nq,
        "steps": index.last_steps, "refreshes": index.refreshes,
    }
    log(f"[sharded] {name} S={S}: recall@10={out['recall@10']:.4f} "
        f"qps={out['qps']:.1f} wall={wall:.3f} s setup={setup_s:.2f} s "
        f"K1 launches={out['gather_score_launches']} hit_rate={out['hit_rate']:.4f} "
        f"rpc_rounds={index.rpc_rounds} ici_lanes/q={out['ici_lanes_per_query']:.1f} "
        f"ici_bytes/q={out['ici_bytes_per_query']:.1f} "
        f"readbacks/batch={out['readbacks_per_batch']:.1f} steps={index.last_steps} "
        f"mean_hops={out['mean_hops']:.2f} refreshes={index.refreshes}")
    if out["recall@10"] < MIN_RECALL:
        raise AssertionError(f"sharded {name}: recall@10 {out['recall@10']:.4f} "
                             f"< {MIN_RECALL}")
    if not out["gather_score_launches"] or set(launches) != {"gather_score"}:
        raise AssertionError(f"sharded {name}: launches {launches}")
    del index
    torch.cuda.empty_cache()
    return out, ids, dd


def _profile_sharded(graph, ds, dev) -> dict:
    """Device time of one S=8 dense batch by kind of kernel (by name: K1;
    the merge's sorts; the copies and concatenations of the collectives
    and gathers; reductions, the psum sums among them), the host reads,
    and the card's busy share of the batch's span."""
    from torch.profiler import ProfilerActivity, profile

    index = ShardedIndex(graph, shard_mesh(8, device=dev))
    q = ds.queries[:B]
    index.search(q, SEARCH, batch_size=B)
    torch.cuda.synchronize()
    reads0 = index.readbacks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(q, SEARCH, batch_size=B)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"gather_score": 0.0, "sort": 0.0, "copy_cat": 0.0, "reduce": 0.0,
             "other": 0.0}
    memcpy_dtoh = 0
    for e in prof.key_averages():
        key = e.key.lower()
        if "memcpy dtoh" in key or "device -> host" in key:
            memcpy_dtoh += e.count
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kind = ("gather_score" if "gather_score" in key else
                "sort" if "sort" in key or "radix" in key else
                "copy_cat" if "copy" in key or "cat" in key or "memcpy" in key else
                "reduce" if "reduce" in key else "other")
        kinds[kind] += ms
    busy = sum(kinds.values())
    out = {"span_ms": span_ms, "busy_ms": busy, "busy_share": busy / span_ms,
           "by_kind_ms": kinds, "readbacks": index.readbacks - reads0,
           "memcpy_dtoh": memcpy_dtoh, "steps": index.last_steps}
    log(f"[profile] sharded dense S=8, one batch of {B}: span {span_ms:.3f} ms "
        f"(profiled), device busy {busy:.3f} ms ({100 * busy / span_ms:.1f}%), "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items())
        + f"; {out['readbacks']} lockstep reads, {memcpy_dtoh} DtoH copies, "
        f"{index.last_steps} steps")
    del index
    torch.cuda.empty_cache()
    return out


def _sharded_int_check(dev) -> dict:
    """An integer-row graph (every sum exact) served on a card mesh and on a
    CPU mesh of 8 shards, dense and compact, with the replica and routing:
    ids, distance bits and counters equal."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(-8, 9, size=SHARD_INT).astype(np.float32)
    queries = rng.integers(-8, 9, size=(SHARD_INT_QUERIES, SHARD_INT[1])
                           ).astype(np.float32)
    t0 = time.perf_counter()
    graph = build_graph(base, HNSWParams(M=8, ef_construction=64), threads=1)
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s}
    for spkw in ({}, {"exchange": "compact"}):
        got = []
        for where in (dev, "cpu"):
            index = ShardedIndex(graph, shard_mesh(8, device=where),
                                 cache_capacity=4096, routing=True)
            t0 = time.perf_counter()
            ids, dd = index.search(queries, SearchParams(k=10, ef=64, frontier=4,
                                                         **spkw),
                                   batch_size=SHARD_INT_QUERIES)
            got.append((ids, dd, {c: getattr(index, c) for c in SHARD_COUNTERS
                                  if c != "readbacks"}, time.perf_counter() - t0))
        (gi, gd, gc, gs), (ci, cd, cc, cs) = got
        what = spkw.get("exchange", "dense")
        if not (np.array_equal(gi, ci) and np.array_equal(gd.view(np.int32),
                                                           cd.view(np.int32))):
            raise AssertionError(f"sharded integer rows, {what}: card and CPU "
                                 f"meshes differ")
        if gc != cc:
            raise AssertionError(f"sharded integer rows, {what}: counters {gc} "
                                 f"against {cc}")
        out[what] = {"card_s": gs, "cpu_s": cs, **gc}
        log(f"[sharded] integer rows {SHARD_INT[0]} x {SHARD_INT[1]}, {what}, "
            f"S=8, cache 4096, routing: card and CPU meshes equal (ids, bits, "
            f"counters {gc}); card {gs:.2f} s, CPU {cs:.2f} s")
    return out


def _sharded_checkpoint(graph, directory: str) -> float:
    """save_graph_sharded at S=4, loaded back equal, then removed."""
    t0 = time.perf_counter()
    save_graph_sharded(graph, directory, 4)
    back = load_graph_sharded(directory)
    for f in ("vectors", "levels", "neighbors0", "upper_row", "upper_neighbors"):
        if not np.array_equal(getattr(back, f), getattr(graph, f)):
            raise AssertionError(f"sharded checkpoint: {f} differs")
    if (back.entry_point, back.top_level) != (graph.entry_point, graph.top_level):
        raise AssertionError("sharded checkpoint: entry point differs")
    shutil.rmtree(directory)
    secs = time.perf_counter() - t0
    log(f"[sharded] checkpoint: save_graph_sharded at S=4, loaded back equal, "
        f"removed: {secs:.2f} s")
    return secs


def sharded_phase(ds, gt, graph_path: str, data_dir: str, flat_recall: float,
                  dev) -> dict:
    """Phase 25: the sharded HNSW path on phase 5's graph. Returns its
    numbers; raises on any failed gate."""
    t_phase = time.perf_counter()
    graph = load_graph(graph_path)
    q = ds.queries[:SHARD_QUERIES]
    single = {}
    for rows in ("f32", "bf16"):
        index = HNSWIndex(graph, rows=rows, device=dev)
        single[rows] = index.search(q, SEARCH, batch_size=B)[0]
        del index
        torch.cuda.empty_cache()
    routes, ref = {}, None
    for name, S, kw, spkw in SHARD_ROUTES:
        routes[name], ids, dd = _serve_sharded(graph, ds, gt, dev, name, S, kw,
                                               spkw)
        rows = kw.get("rows", "f32")
        agree = float((ids == single[rows]).mean())
        routes[name]["agree_single"] = agree
        if agree < SHARD_MIN_AGREE:
            raise AssertionError(f"sharded {name}: ids agree with the single-card "
                                 f"{rows} index on {agree:.5f} of slots")
        if rows == "f32":
            if ref is None:
                ref = (ids, dd.view(np.int32))
            elif not (np.array_equal(ids, ref[0])
                      and np.array_equal(dd.view(np.int32), ref[1])):
                raise AssertionError(f"sharded {name}: ids or distance bits differ "
                                     f"from {SHARD_ROUTES[0][0]}")
        log(f"[sharded]   {name}: ids agree with the single-card {rows} index on "
            f"{agree:.5f} of slots" + ("; bits equal to dense_s4" if rows == "f32"
                                       else ""))
    out = {"routes": routes, "profile": _profile_sharded(graph, ds, dev),
           "integer_rows": _sharded_int_check(dev),
           "checkpoint_s": _sharded_checkpoint(
               graph, os.path.join(os.path.dirname(graph_path), "sharded4"))}
    del graph
    data = ["--data-path", data_dir, *CLI_COMMON]
    cli_runs = (
        ("sharded_hnsw", data + ["--index", "hnsw", "--load-index", graph_path,
                                 *CLI_HNSW, "--num-queries", str(SHARD_QUERIES),
                                 "--shards", "4", "--cache", "--routing"],
         routes["dense_s4"]["recall@10"], "gather_score"),
        ("sharded_flat", data + ["--index", "flat", "--shards", "4",
                                 "--num-queries", str(CLI_FLAT_QUERIES)],
         flat_recall, None),
    )
    for name, argv, want, kernel in cli_runs:
        doc, launches, _ = run_cli(argv, name)
        got = doc["queries"]["recall"]
        if got != want:
            raise AssertionError(f"cli {name}: recall@10 {got} against {want}")
        if kernel and not launches.get(kernel):
            raise AssertionError(f"cli {name}: {kernel} never launched")
        if doc["meta"]["num_shards"] != 4 or len(doc["meta"]["shard_devices"]) != 4:
            raise AssertionError(f"cli {name}: meta {doc['meta']}")
        out[name] = {"recall": got, "qps": doc["queries"]["queries_per_sec"],
                     "cache": doc["cache"], "launches": launches,
                     "shard_devices": doc["meta"]["shard_devices"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[sharded] phase 25: {out['phase_s']:.1f} s")
    log(f"[sharded] summary {json.dumps(out)}")
    return out


# --- phase 26: the sharded scan families, stacked on the card ------------------

SCAN_S = 4  # shards of every phase-26 mesh, stacked on the one card
SCAN_SEED = 1234  # the split shuffle, the IVF build and the CLI runs' --seed
SCAN_FLAT_GAP = 0.005  # sharded FastFlat auto against phase 7's single card
SCAN_SPLIT_MIN = {"int8": 0.90, "bf16": 0.98}
SCAN_C11_BATCHES = (64, 2048)
SCAN_INT = (65_536, 16)  # the integer-row set served on a card and a CPU mesh
SCAN_INT_QUERIES = 256
SCAN_INT_COUNTERS = ("rpc_rounds", "scanned_lanes", "last_coverage", "last_overflow",
                     "last_lanes", "last_fallback")
# 26e: the direct sharded routed build at the 4.19M operating point, and the
# size at which it is held bit for bit against from_single
SCAN_CAP_ROUTED_N, SCAN_CAP_SMALL_N = 4_194_304, 262_144
SCAN_CAP_ROUTE = (32, 256, 32)  # p:P:T
# every phase-26 number, printed as one [sharded-scan] summary line
SHARDED_SCAN: dict = {}


def _scan_launches() -> dict[str, int]:
    """The launches since reset_launches of every kernel a sharded scan
    family can run, by form, those above 0."""
    counts = {name: f[0].launches for name, f in K2_FORMS.items()}
    for name, (f, _, _) in K3_FUNCS.items():
        counts.update({f"{name}[{dt},keep{2 if k2 else 1}]": n
                       for (dt, k2), n in f.form_launches.items()})
    counts.update({f"routed_classmax_scan[{dt},T{t}]": n
                   for (dt, t), n in k4.routed_classmax_scan.form_launches.items()})
    counts.update({"gather_score": gather_score.launches,
                   "regen_score": rg.regen_score.launches,
                   "regen_rows": rg.regen_rows.launches})
    return {k: v for k, v in counts.items() if v}


def _scan_timed(run, nq: int, warm=None) -> tuple:
    """``warm()`` (default ``run()``) untimed, then the counts at 0 and one
    timed ``run()``: (its result, QPS, launches, wall seconds)."""
    (warm or run)()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, nq / wall, _scan_launches(), wall


def _per_batch(launches: dict, name: str, batches: int, what: str) -> None:
    """A kernel of the route launched once a shard a batch."""
    if launches.get(name, 0) != SCAN_S * batches:
        raise AssertionError(f"{what}: {name} launched {launches.get(name, 0)} times, "
                             f"not {SCAN_S} shards x {batches} batches")


def _shard_k2_bound(rows: int, width: int, cls: int) -> tuple[float, str]:
    """K2a's work on one shard: its rows at the packed width read once, the
    queries, the (B, cls) outputs."""
    return scan_bound(rows, B, width, width * 2, B * cls * 2)


def _shard_k2_check(index, q: np.ndarray, cls: int) -> dict:
    """Every K2 form on shard 0's table (its own tensor, 253,952 rows at the
    1M set) against its twin at the routes' shapes, the fused forms equal to
    the unfused form plus select; K2a timed with its bound."""
    ext = index.ext[0]
    qe = pack_ext_query(torch.from_numpy(q[:B]).to(ext.device), ext.shape[1]).to(
        torch.bfloat16)
    out = {"rows": int(ext.shape[0]), "cls": cls}
    unfused = {}
    for name in ("classmax_scan", "classmax2_scan"):
        fn, ref, _ = K2_FORMS[name]
        got = fn(ext, qe, cls=cls)
        err = _k2_err(got, ref(ext, qe, cls=cls), cls)
        if err > K2_ATOL:
            raise AssertionError(f"26a {name} on a shard: scores differ by {err}")
        out[f"{name}_max_abs_err"] = err
        unfused[name] = got
    for name, kb in (("classmax_topk_scan", 16), ("classmax2_topk_scan", 32)):
        got = K2_FORMS[name][0](ext, qe, kb=kb, cls=cls)
        base_form = unfused[name.replace("_topk", "")]
        vals, sel = cm.select_lanes(base_form[0], kb)
        want = (vals,) + tuple(torch.gather(p, 1, sel) for p in base_form[1:])
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"26a {name} on a shard: not the unfused form plus "
                                 "select")
        _check_rescored(ext, qe, got, name)
    out["ms"] = cuda_ms(lambda: cm.classmax_scan(ext, qe, cls=cls), reps=10)
    out["plain_ms"] = cuda_ms(lambda: cm.classmax_scan_ref(ext, qe, cls=cls), reps=3,
                              warmup=1)
    out["bound_ms"], out["bound_by"] = _shard_k2_bound(ext.shape[0], D + 2, cls)
    out["max_abs_err"] = out["classmax_scan_max_abs_err"]
    log(f"[sharded-scan] 26a K2 forms on shard 0 ({out['rows']} rows, cls={cls}): "
        f"{json.dumps(out)}")
    return out


def _serve_scan(name: str, run, nq: int, gt, warm=None) -> dict:
    (ids, dd), qps, launches, wall = _scan_timed(run, nq, warm)
    r = {"recall@10": recall_at_k(ids, gt[:nq], 10), "qps": qps, "wall_s": wall,
         "launches": launches}
    log(f"[sharded-scan] {name}: {json.dumps(r)}")
    return r, ids, dd


def sharded_flat(ds, gt, flat_auto: float, flat_qps: float, mesh) -> tuple:
    """26a: ShardedFastFlatIndex on the 1M set through phase 7's four routes
    (one K2 form each), every K2 form on a shard against its twin."""
    t0 = time.perf_counter()
    index = ShardedFastFlatIndex(ds.base, mesh)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "rows_per_shard": index.rows,
           "routes": {}}
    for route, knobs in FLAT_ROUTES:
        kb, cls, keep2, fused = index.resolve_knobs(10, knobs.get("kb", 0), 0,
                                                    knobs.get("keep2"))
        tq = knobs.get("tq", 512)  # the search rounds its batch up to tq
        batches = -(-NQ // max(tq, -(-B // tq) * tq))
        form = ("classmax2" if keep2 else "classmax") + ("_topk_scan" if fused
                                                         else "_scan")
        r, ids, _ = _serve_scan(
            f"26a fastflat {route} ({form}, kb={kb}, cls={cls})",
            lambda: index.search(ds.queries, 10, batch_size=B, **knobs), NQ, gt,
            warm=lambda: index.search(ds.queries[:B], 10, batch_size=B, **knobs))
        r.update(form=form, kb=kb, cls=cls)
        _per_batch(r["launches"], form, batches, f"26a {route}")
        floor = FLAT_MIN_RECALL if route in ("auto", "keep2_point") else \
            FLAT_ROUTE_MIN_RECALL
        if r["recall@10"] < floor:
            raise AssertionError(f"26a {route}: recall@10 {r['recall@10']:.4f} < {floor}")
        if not ((ids >= 0) & (ids < N)).all():
            raise AssertionError(f"26a {route}: an id is not a real row")
        out["routes"][route] = r
    auto = out["routes"]["auto"]
    auto["single_card"] = {"recall@10": flat_auto, "qps": flat_qps}
    if auto["recall@10"] < flat_auto - SCAN_FLAT_GAP:
        raise AssertionError(f"26a auto: recall@10 {auto['recall@10']:.4f} more than "
                             f"{SCAN_FLAT_GAP} under the single card's {flat_auto:.4f}")
    profile_run(lambda: index.search(ds.queries[:B], 10, batch_size=B),
                "26a sharded fastflat auto S=4")
    out["per_shard"] = _shard_k2_check(index, ds.queries, auto["cls"])
    log(f"[sharded-scan] 26a auto: {auto['qps']:.1f} QPS against the single card's "
        f"{flat_qps:.1f} (phase 7)")
    return index, out


def _shard_k3_check(index, q: np.ndarray, cls: int) -> dict:
    """Both K3 functions, keep1 and keep2, on shard 0's split tables against
    their twins; the fused forms equal to the unfused plus select; the
    route's form timed with its bound."""
    comp, aux = index.comp[0], index.aux[0]
    qs = pack_split_query(torch.from_numpy(q[:B]).to(comp.device), comp.shape[1])
    out = {"rows": int(comp.shape[0]), "cls": cls}
    for keep2 in (False, True):
        got = cm.classmax_scan_split(comp, aux, qs, cls=cls, keep2=keep2)
        err = _k2_err(got, cm.classmax_scan_split_ref(comp, aux, qs, cls=cls,
                                                      keep2=keep2), cls)
        if err > K3_ATOL:
            raise AssertionError(f"26b K3 keep2={keep2} on a shard: scores differ by "
                                 f"{err}")
        out[f"keep{2 if keep2 else 1}_max_abs_err"] = err
        fused = cm.classmax_topk_scan_split(comp, aux, qs, kb=32, cls=cls, keep2=keep2)
        vals, sel = cm.select_lanes(got[0], 32)
        want = (vals,) + tuple(torch.gather(p, 1, sel) for p in got[1:])
        if not all(torch.equal(g, w) for g, w in zip(fused, want)):
            raise AssertionError(f"26b fused K3 keep2={keep2} on a shard: not the "
                                 "unfused form plus select")
    out["ms"] = cuda_ms(lambda: cm.classmax_scan_split(comp, aux, qs, cls=cls), reps=10)
    out["plain_ms"] = cuda_ms(lambda: cm.classmax_scan_split_ref(comp, aux, qs, cls=cls),
                              reps=3, warmup=1)
    rows = comp.shape[0]
    out["bound_ms"], out["bound_by"] = scan_bound(
        rows, B, D, D * comp.element_size() + 8, B * cls * 2)
    out["max_abs_err"] = out["keep1_max_abs_err"]
    return out


def sharded_split(ds, gt, split_served: dict, mesh) -> dict:
    """26b: ShardedSplitFlatIndex.from_host, int8 and bf16, at the auto knobs;
    the perm map; every K3 form on a shard against its twin."""
    out = {}
    batches = -(-NQ // B)
    for comp_dtype in SPLIT_DTYPES[::-1]:  # int8 first: the CLI's layout
        t0 = time.perf_counter()
        index = ShardedSplitFlatIndex.from_host(ds.base, mesh, comp_dtype=comp_dtype,
                                                seed=SCAN_SEED)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kb, cls, keep2, fused = index.resolve_knobs(10, 32, 0, None)
        fn = "classmax_topk_scan_split" if fused else "classmax_scan_split"
        form = f"{fn}[{comp_dtype},keep{2 if keep2 else 1}]"
        r, ids, _ = _serve_scan(
            f"26b split {comp_dtype} auto ({form}, kb={kb}, cls={cls})",
            lambda: index.search(ds.queries, 10, batch_size=B), NQ, gt,
            warm=lambda: index.search(ds.queries[:B], 10, batch_size=B))
        _per_batch(r["launches"], form, batches, f"26b {comp_dtype}")
        if r["recall@10"] < SCAN_SPLIT_MIN[comp_dtype]:
            raise AssertionError(f"26b {comp_dtype}: recall@10 {r['recall@10']:.4f} < "
                                 f"{SCAN_SPLIT_MIN[comp_dtype]}")
        real = (ids >= 0) & (ids < N)
        if not real.all() or len(np.unique(index.perm)) != N:
            raise AssertionError(f"26b {comp_dtype}: an id is not a real row")
        r.update(build_s=build_s, form=form, kb=kb, cls=cls,
                 rows_per_shard=index.rows,
                 single_card=split_served.get((comp_dtype, "auto")))
        r["per_shard"] = _shard_k3_check(index, ds.queries, cls)
        log(f"[sharded-scan] 26b {comp_dtype}: K3 on shard 0 "
            f"{json.dumps(r['per_shard'])}")
        out[comp_dtype] = r
        if comp_dtype == "int8":
            out["_index"] = index
        else:
            del index
    torch.cuda.empty_cache()
    return out


def sharded_ivf(ds, gt, ivf_single: dict, mesh, dev) -> tuple:
    """26c: ShardedIVFIndex on the 1M set: compact search at probes 16/32/64,
    compact equal to dense id for id, the rounds, lanes and host reads a
    batch; search_routed at the command line's knobs; full probes over the
    first 65,536 rows."""
    t0 = time.perf_counter()
    index = ShardedIVFIndex(ds.base, mesh, seed=SCAN_SEED)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "C": index.C, "cap": index.cap,
           "probes": {}}
    fine_c = -(-N // 128)  # the fine layout's C, then rounded up to the mesh
    if index.C != -(-fine_c // SCAN_S) * SCAN_S:
        raise AssertionError(f"26c: C={index.C}")
    batches = -(-NQ // B)
    last = 0.0
    for p in IVF_PROBES:
        index.rpc_rounds = index.scanned_lanes = 0
        reads0 = mesh.readbacks
        r, _, _ = _serve_scan(
            f"26c ivf compact probes={p}",
            lambda: index.search(ds.queries, 10, probes=p, batch_size=B), NQ, gt,
            warm=lambda: index.search(ds.queries[:B], 10, probes=p, batch_size=B))
        reads = mesh.readbacks - reads0
        # the warm-up batch's rounds count too; its reads are the first batch's
        r.update(rpc_rounds=index.rpc_rounds, scanned_lanes=index.scanned_lanes,
                 readbacks_per_batch=reads / (batches + 1),
                 single_card=ivf_single["fine"].get(p))
        if r["recall@10"] < last:
            raise AssertionError(f"26c: recall fell at probes {p}")
        if not r["launches"].get("gather_score") or set(r["launches"]) != {"gather_score"}:
            raise AssertionError(f"26c probes {p}: launches {r['launches']}")
        last = r["recall@10"]
        out["probes"][p] = r
    q = ds.queries[:B]
    profile_run(lambda: index.search(q, 10, probes=IVF_E2E_PROBES, batch_size=B),
                f"26c sharded ivf compact probes={IVF_E2E_PROBES} S=4")
    ci, _ = index.search(q, 10, probes=IVF_E2E_PROBES, batch_size=B)
    di, _ = index.search(q, 10, probes=IVF_E2E_PROBES, batch_size=B, probe_lanes="dense")
    if not np.array_equal(ci, di):
        raise AssertionError("26c: the compact lanes differ from the dense scan")
    knobs = dict(IVF_ROUTES)["cli"]
    r, _, _ = _serve_scan(f"26c ivf search_routed {knobs}",
                          lambda: index.search_routed(ds.queries, 10, **knobs), NQ, gt,
                          warm=lambda: index.search_routed(ds.queries[:B], 10, **knobs))
    out["routed_cli"] = r
    n_full = IVF_FULL_N
    full = ShardedIVFIndex(ds.base[:n_full], mesh, num_clusters=IVF_FULL_C,
                           seed=SCAN_SEED)
    qf = ds.queries[:IVF_FULL_QUERIES]
    sub_gt, _ = exact_knn(torch.from_numpy(ds.base[:n_full]).to(dev),
                          torch.from_numpy(qf).to(dev), 10)
    fi, _ = full.search(qf, 10, probes=IVF_FULL_C, batch_size=IVF_FULL_QUERIES,
                        rerank=8)
    out["full_probes_recall"] = recall_at_k(fi, sub_gt.cpu().numpy(), 10)
    log(f"[sharded-scan] 26c: compact == dense on {B} queries; full probes over "
        f"{n_full} rows: recall@10 {out['full_probes_recall']:.4f}")
    if out["full_probes_recall"] < IVF_FULL_MIN_RECALL:
        raise AssertionError(f"26c full probes: recall {out['full_probes_recall']}")
    del full
    return index, out


def _c11_sharded(families: dict) -> dict:
    """26g, ROADMAP C11 on the mesh: the first 64 queries alone and inside a
    batch of 2,048: equal ids and distance bits."""
    out = {}
    for name, (run, q64, filler) in families.items():
        res = []
        for b in SCAN_C11_BATCHES:
            ids, dd = run(np.ascontiguousarray(np.concatenate([q64, filler[:b - 64]])), b)
            res.append((ids[:64], np.asarray(dd[:64], np.float32).view(np.uint32)))
        same = bool(np.array_equal(res[0][0], res[1][0])
                    and np.array_equal(res[0][1], res[1][1]))
        out[name] = same
        log(f"[sharded-scan] 26g C11 {name}: 64 queries alone and in a batch of "
            f"{SCAN_C11_BATCHES[1]}: ids and distance bits equal {same}")
        if not same:
            raise AssertionError(f"26g C11: sharded {name} answers by its batch")
    return out


def _int_layouts(base: np.ndarray) -> tuple:
    """The IVF layout and the routed index of integer rows, built once on
    the CPU: their k-means sums in another order on the card would cluster
    otherwise, and the check is of the searches."""
    n, d = base.shape
    ivf = build_ivf_layout(base, 256, seed=7, device="cpu")
    routed = build_routed_split(n, d, base_dev=torch.from_numpy(base), cap_target=512,
                                cls=128, seed=3, shards=SCAN_S)
    return ivf, routed


def _int_families(base: np.ndarray, mesh, layouts: tuple) -> dict:
    """Every sharded scan family over integer rows on ``mesh``, the IVF and
    routed ones from ``_int_layouts``."""
    layout, single = layouts
    fast = ShardedFastFlatIndex(base, mesh, seed=1)
    split = ShardedSplitFlatIndex.from_host(base, mesh, comp_dtype="int8", seed=1)
    ivf = ShardedIVFIndex.from_parts(mesh, layout.centroids, layout.blocks,
                                     layout.block_sq, layout.block_ids, base)
    routed = ShardedRoutedSplitIndex.from_single(single, mesh)
    nq = SCAN_INT_QUERIES
    return {
        "fastflat": (lambda q: fast.search(q, 10, batch_size=nq), fast),
        "split_int8": (lambda q: split.search(q, 10, batch_size=nq), split),
        "ivf_compact": (lambda q: ivf.search(q, 10, probes=16, batch_size=nq), ivf),
        "ivf_dense": (lambda q: ivf.search(q, 10, probes=16, batch_size=nq,
                                           probe_lanes="dense"), ivf),
        "ivf_routed": (lambda q: ivf.search_routed(q, 10, probes=8, shared=16, tile=32,
                                                   batch_size=nq), ivf),
        "routed": (lambda q: routed.search(q, 10, probes=8, shared=16, tile=32,
                                           batch_size=nq), routed),
    }


def _scan_int_check(dev) -> dict:
    """26g: integer rows (every sum exact) served by every sharded scan
    family on a card mesh and a CPU mesh of 4 shards: ids, distance bits and
    counters equal."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(-8, 9, size=SCAN_INT).astype(np.float32)
    q = rng.integers(-8, 9, size=(SCAN_INT_QUERIES, SCAN_INT[1])).astype(np.float32)
    got = {}
    layouts = _int_layouts(base)
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        fams = _int_families(base, shard_mesh(SCAN_S, device=where), layouts)
        got[str(where)] = {name: (*run(q), {c: getattr(idx, c) for c in SCAN_INT_COUNTERS
                                            if hasattr(idx, c)})
                           for name, (run, idx) in fams.items()}
        got[str(where) + "_s"] = time.perf_counter() - t0
    out = {"card_s": got[str(dev) + "_s"], "cpu_s": got["cpu_s"]}
    for name, (gi, gd, gc) in got[str(dev)].items():
        ci, cd, cc = got["cpu"][name]
        if not (np.array_equal(gi, ci) and np.array_equal(gd.view(np.int32),
                                                           cd.view(np.int32))):
            raise AssertionError(f"26g integer rows, {name}: card and CPU meshes differ")
        if gc != cc:
            raise AssertionError(f"26g integer rows, {name}: counters {gc} against {cc}")
        out[name] = gc
    log(f"[sharded-scan] 26g integer rows {SCAN_INT[0]} x {SCAN_INT[1]}, S={SCAN_S}: "
        f"card and CPU meshes equal for {sorted(got['cpu'])} (ids, bits, counters); "
        f"card {out['card_s']:.2f} s, CPU {out['cpu_s']:.2f} s")
    return out


def _library_routed(ds, gt, mesh, dev) -> dict:
    """The command line's routed --shards 4 run as library calls: the build at
    its defaults with shards=4, dealt by from_single (base mode), the auto
    knobs."""
    base_t = torch.from_numpy(ds.base).to(dev)
    single = build_routed_split(N, D, base_dev=base_t, seed=SCAN_SEED, shards=SCAN_S)
    index = ShardedRoutedSplitIndex.from_single(single, mesh)
    del single
    r, _, _ = _serve_scan("26f library routed (the CLI's build, base mode)",
                          lambda: index.search(ds.queries, 10, batch_size=B), NQ, gt)
    del index, base_t
    torch.cuda.empty_cache()
    return r


def sharded_cli(ds, gt, data_dir: str, want: dict, mesh, dev) -> dict:
    """26f: the command line with --shards 4 on phase 22's saved set: each run
    reads its library run's recall exactly and launches its kernels."""
    want = dict(want, routed=_library_routed(ds, gt, mesh, dev))
    data = ["--data-path", data_dir, *CLI_COMMON, "--shards", str(SCAN_S),
            "--seed", str(SCAN_SEED)]
    runs = (("fastflat", ["--index", "fastflat"], "classmax_scan"),
            ("split", ["--index", "split"], "classmax_scan_split"),
            ("routed", ["--index", "routed", "--probes", "0"], "routed_classmax_scan"),
            ("ivf", ["--index", "ivf", "--probes", str(IVF_E2E_PROBES)], "gather_score"),
            # the sharded tile-shared search launches no kernel: its products
            # are a batched matmul and its re-rank is the host's, as in JAX
            ("ivf_routed", ["--index", "ivf", "--ivf-routed"], None))
    out = {}
    for name, flags, kernel in runs:
        doc, launches, _ = run_cli(data + flags, f"sharded {name}")
        got, lib = doc["queries"]["recall"], want[name]
        if got != lib["recall@10"]:
            raise AssertionError(f"26f {name}: recall {got} against the library's "
                                 f"{lib['recall@10']}")
        if kernel and not launches.get(kernel):
            raise AssertionError(f"26f {name}: {kernel} never launched")
        if doc["meta"]["num_shards"] != SCAN_S:
            raise AssertionError(f"26f {name}: meta {doc['meta']}")
        out[name] = {"recall": got, "qps": doc["queries"]["queries_per_sec"],
                     "library_qps": lib["qps"], "launches": launches,
                     "index_bytes": doc["build"]["index_size_in_bytes"]}
    return out


def sharded_scan_phase(ds, gt, flat_served: dict, split_served: dict, ivf_single: dict,
                       data_dir: str, dev) -> None:
    """Phases 26a-c, f and g on the 1M set and phase 22's saved copy of it;
    the numbers land in SHARDED_SCAN."""
    t_phase = time.perf_counter()
    mesh = shard_mesh(SCAN_S, device=dev)
    flat, SHARDED_SCAN["26a"] = sharded_flat(ds, gt, *flat_served["auto"], mesh)
    split = sharded_split(ds, gt, split_served, mesh)
    split_int8 = split.pop("_index")
    SHARDED_SCAN["26b"] = split
    ivf, SHARDED_SCAN["26c"] = sharded_ivf(ds, gt, ivf_single, mesh, dev)
    q64, filler = ds.queries[:64], ds.queries[64:]
    SHARDED_SCAN["26g_c11"] = _c11_sharded({
        "fastflat": (lambda q, b: flat.search(q, 10, batch_size=b), q64, filler),
        "split_int8": (lambda q, b: split_int8.search(q, 10, batch_size=b), q64, filler),
        "ivf": (lambda q, b: ivf.search(q, 10, probes=16, batch_size=b), q64, filler)})
    want = {"fastflat": SHARDED_SCAN["26a"]["routes"]["auto"],
            "split": SHARDED_SCAN["26b"]["int8"],
            "ivf": SHARDED_SCAN["26c"]["probes"][IVF_E2E_PROBES],
            "ivf_routed": SHARDED_SCAN["26c"]["routed_cli"]}
    del flat, split_int8, ivf
    torch.cuda.empty_cache()
    SHARDED_SCAN["26f_cli"] = sharded_cli(ds, gt, data_dir, want, mesh, dev)
    SHARDED_SCAN["26g_integer_rows"] = _scan_int_check(dev)
    SHARDED_SCAN["26abcfg_s"] = time.perf_counter() - t_phase
    log(f"[sharded-scan] phases 26a-c, f, g: {SHARDED_SCAN['26abcfg_s']:.1f} s")


def _attach_sharded(kernels: list[dict]) -> None:
    """Each kernel entry gains the launches of every phase-26 run that ran
    it (``sharded_launches``, by run) and, for K2a, K3 keep1 and K4 at T=64,
    its numbers at a shard's shape (``per_shard``)."""
    by_name = {k["name"]: k for k in kernels}

    def walk(node, path):
        if isinstance(node, dict):
            if isinstance(node.get("launches"), dict):
                for name, n in node["launches"].items():
                    if name in by_name:
                        by_name[name].setdefault("sharded_launches", {})[path] = n
            for key, value in node.items():
                if key != "launches":
                    walk(value, f"{path} {key}".strip())
    walk(SHARDED_SCAN, "")
    per_shard = {"classmax_scan": SHARDED_SCAN["26a"]["per_shard"],
                 "classmax_scan_split[int8,keep1]": SHARDED_SCAN["26b"]["int8"]["per_shard"],
                 "classmax_scan_split[bf16,keep1]": SHARDED_SCAN["26b"]["bf16"]["per_shard"],
                 "routed_classmax_scan[int8,T64]": SHARDED_SCAN["26d"]["per_shard"]}
    for name, case in per_shard.items():
        if name in by_name:
            by_name[name]["per_shard"] = case


def sharded_routed_phase(index: RoutedSplitIndex, ds, gt, served: dict, dev) -> dict:
    """26d: phase 12's index dealt over 4 shards (base mode) at the auto knobs
    and the starved grant with its spill; coverage equal to the single
    card's; K4 at a shard's shape against its twin."""
    t_phase = time.perf_counter()
    if index.C % SCAN_S:
        raise AssertionError(f"26d: C={index.C} is not a multiple of {SCAN_S}")
    mesh = shard_mesh(SCAN_S, device=dev)
    t0 = time.perf_counter()
    sh = ShardedRoutedSplitIndex.from_single(index, mesh)
    torch.cuda.synchronize()
    out = {"from_single_s": time.perf_counter() - t0, "C_loc": sh.C_loc, "routes": {}}
    for route, knobs in (("auto", {}), ("starved", dict(ROUTED_ROUTES)["starved"])):
        r, _, _ = _serve_scan(
            f"26d routed {route}", lambda: sh.search(ds.queries, 10, batch_size=B, **knobs),
            NQ, gt, warm=lambda: sh.search(ds.queries[:B], 10, batch_size=B, **knobs))
        probes, P, P_loc, T, kk = sh.resolve_knobs(10, 0, knobs.get("shared", 0), 0,
                                                   knobs.get("tile", 0), 0)
        r.update(coverage=sh.last_coverage, overflow=sh.last_overflow,
                 lanes=sh.last_lanes, spilled=sh.last_fallback, probes=probes, P=P,
                 P_loc=P_loc, T=T, kk=kk, single_card={
                     k: served[route][k] for k in ("recall", "qps", "coverage",
                                                   "fallback")})
        log(f"[sharded-scan] 26d {route}: coverage {sh.last_coverage} (single card "
            f"{served[route]['coverage']}), overflow {sh.last_overflow}, lanes "
            f"{sh.last_lanes}, spilled {sh.last_fallback}")
        if sh.last_coverage != served[route]["coverage"]:
            raise AssertionError(f"26d {route}: coverage differs from the single card's")
        if route == "auto" and r["recall@10"] < ROUTED_MIN_RECALL:
            raise AssertionError(f"26d auto: recall@10 {r['recall@10']:.4f}")
        if not r["launches"].get(f"routed_classmax_scan[int8,T{T}]"):
            raise AssertionError(f"26d {route}: K4 never launched")
        if not r["launches"].get("gather_score"):
            raise AssertionError(f"26d {route}: the base re-rank never ran")
        out["routes"][route] = r
    # K4 at a shard's shape: shard 0's table and its columns of one batch
    probes, P, P_loc, T, _ = sh.resolve_knobs(10, 0, 0, 0, 0, 0)
    q = torch.from_numpy(ds.queries[:B]).to(dev)
    q_s, _, _, pr_s, cols, _ = sh._plans(q, probes, P, T)[0]
    lcol = sh.shard_columns(0, pr_s, cols, P_loc)[0]
    out["per_shard"] = _k4_case(sh.comp[0], sh.aux_r[0], q_s, lcol, T, sh.cap, sh.cls,
                                f"26d shard 0 ({sh.C_loc + 1} clusters, {P_loc} lanes)",
                                timed=True)
    del sh
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    SHARDED_SCAN["26d"] = out
    log(f"[sharded-scan] phase 26d: {out['seconds']:.1f} s")
    return out


def sharded_capacity_flat(sds, eds, dev) -> dict:
    """26e, flat: the row-keyed 1M datasets ingested over 4 shards equal
    phase 24's single-card ones bit for bit, then served from the mesh."""
    mesh = shard_mesh(SCAN_S, device=dev)
    out = {}
    t0 = time.perf_counter()
    reset_launches()
    ms = tds.device_rowkeyed_split_dataset(n=CAP_1M, dim=D, num_queries=CAP_NQ,
                                           seed=CAP_SEED, gt_k=10, comp_dtype="int8",
                                           mesh=mesh)
    torch.cuda.synchronize()
    ingest = {"seconds": time.perf_counter() - t0, "launches": _scan_launches()}
    same = (torch.equal(torch.cat(ms.comp_dev), sds.comp_dev)
            and torch.equal(torch.cat(ms.aux_dev, 1), sds.aux_dev)
            and np.array_equal(ms.ground_truth, sds.ground_truth))
    if not same:
        raise AssertionError("26e: the mesh split dataset differs from the single card's")
    idx = ShardedSplitFlatIndex.from_dataset(ms, mesh, dim=D)
    r, _, _ = _serve_scan("26e split 1M from_dataset (kb=64)",
                          lambda: idx.search(ms.queries, 10, kb=64, batch_size=CAP_NQ),
                          CAP_NQ, ms.ground_truth)
    r["ingest"] = ingest
    if r["recall@10"] < CAP_MIN_RECALL or not r["launches"].get("regen_score") or not any(
            k.startswith("classmax_scan_split[int8") or k.startswith(
                "classmax_topk_scan_split[int8") for k in r["launches"]):
        raise AssertionError(f"26e split: {r}")
    out["split_1m"] = r
    del idx, ms
    t0 = time.perf_counter()
    reset_launches()
    me = tds.device_rowkeyed_ext_dataset(n=CAP_1M, dim=D, num_queries=CAP_NQ,
                                         seed=CAP_SEED, gt_k=10, mesh=mesh)
    torch.cuda.synchronize()
    ingest = {"seconds": time.perf_counter() - t0, "launches": _scan_launches()}
    if not (torch.equal(torch.cat(me.ext_dev).view(torch.int16),
                        eds.ext_dev.view(torch.int16))
            and np.array_equal(me.ground_truth, eds.ground_truth)):
        raise AssertionError("26e: the mesh ext dataset differs from the single card's")
    idx = ShardedFastFlatIndex.from_ext(me.ext_dev, me.n, mesh, dim=D,
                                        row_source=me.row_source)
    r, _, _ = _serve_scan("26e ext 1M from_ext (auto knobs)",
                          lambda: idx.search(me.queries, 10, batch_size=CAP_NQ),
                          CAP_NQ, me.ground_truth)
    r["ingest"] = ingest
    if r["recall@10"] < CAP_MIN_RECALL or not r["launches"].get("regen_score"):
        raise AssertionError(f"26e ext: {r}")
    out["ext_1m"] = r
    del idx, me
    torch.cuda.empty_cache()
    return out


def sharded_capacity_routed(dev) -> dict:
    """26e, routed: build_routed_split_sharded of 4,194,304 row-keyed rows
    with its stage seconds and peak memory, served at 32:256:32; and at
    262,144 rows the direct build equal to from_single of the single build."""
    mesh = shard_mesh(SCAN_S, device=dev)
    k1, centers, queries = tds._rowkeyed_recipe(SCAN_CAP_ROUTED_N, D, CAP_NQ, 64,
                                                CAP_SEED, True, dev)
    q_np = queries.cpu().numpy()
    stages = []

    def say(m):
        stages.append(m)
        log(f"[sharded-scan] 26e {m}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    index, gt = build_routed_split_sharded(SCAN_CAP_ROUTED_N, D, mesh,
                                           row_source=(k1, centers), queries=q_np,
                                           log=say, **CAP_BUILD)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "stages": stages, "C": index.C,
           "cap": index.cap, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "before_gb": mem0 / 1e9, "build": {"launches": _scan_launches()}}
    p, P, T = SCAN_CAP_ROUTE
    r, _, _ = _serve_scan(f"26e routed {SCAN_CAP_ROUTED_N} direct build {p}:{P}:{T}",
                          lambda: index.search(q_np, 10, probes=p, shared=P, tile=T,
                                               batch_size=CAP_NQ), CAP_NQ, gt)
    r.update(coverage=index.last_coverage, overflow=index.last_overflow,
             spilled=index.last_fallback)
    out["route"] = r
    log(f"[sharded-scan] 26e routed build: {out['build_s']:.2f} s, C={index.C}, peak "
        f"allocated {out['peak_gb']:.3f} GB")
    if r["recall@10"] < CAP_MIN_RECALL or not r["launches"].get(
            f"routed_classmax_scan[int8,T{T}]") or not r["launches"].get("regen_score"):
        raise AssertionError(f"26e routed: {r}")
    del index
    torch.cuda.empty_cache()
    kw = dict(row_source=(k1, centers), **CAP_BUILD)
    single = build_routed_split(SCAN_CAP_SMALL_N, D, shards=SCAN_S, **kw)
    dealt = ShardedRoutedSplitIndex.from_single(single, mesh)
    direct = build_routed_split_sharded(SCAN_CAP_SMALL_N, D, mesh, **kw)
    same = all(torch.equal(a, b) for name in ("comp", "aux_r", "gid")
               for a, b in zip(getattr(dealt, name), getattr(direct, name)))
    out["small_bit_identical"] = same
    log(f"[sharded-scan] 26e at {SCAN_CAP_SMALL_N} rows: the direct build equals "
        f"from_single of build_routed_split(shards={SCAN_S}) bit for bit: {same}")
    if not same:
        raise AssertionError("26e: the direct sharded build differs from from_single")
    del single, dealt, direct
    torch.cuda.empty_cache()
    return out


# --- phase 24: the row-keyed capacity path -------------------------------------

# the JAX package's capacity recipe (scripts/scale_capacity_routed.py): rows
# and 2048 queries from the row-keyed generator at seed 17, d=128, L2
CAP_SEED, CAP_NQ = 17, 2048
CAP_1M = 1_048_576  # bench.py's capacity_split_1m row (bench.py:608-641)
CAP_N = 41_943_040  # scale_capacity_routed.py's N
CAP_BUILD = dict(cap_target=4096, cls=1024, cap_slack=1.05, comp_dtype="int8",
                 seed=CAP_SEED)
# (name, probes, shared, tile) at 41.9M; the JAX record on this generator
# read recall@10 0.9549 at 32:256:32 (results/scale_capacity_routed.jsonl)
CAP_ROUTES = (("16:192:32", 16, 192, 32), ("32:256:32", 32, 256, 32))
CAP_GATE_ROUTE = "32:256:32"
CAP_MIN_RECALL = 0.90  # the int8 flat gate (PERF.md section 2)
CAP_MIN_CROSSCHECK = 0.995  # the scale script's scorer gate
F32_BASE_BYTES = CAP_N * D * 4  # the f32 base the build must never hold
# the kernels' shapes on the main path: a 1M-row build chunk's worth of ids,
# and the routed re-rank's batch (B=4096, kk=8k=80)
REGEN_ROWS_M, REGEN_B, REGEN_KK = 1_048_576, 4096, 80
# 32-bit integer work: a threefry2x32 hash is 20 rounds of add, rotate and
# xor plus 5 key injections of 3 adds and 2 first adds (77); a row's draw
# takes 7 hashes and randint's three remainders, an element one hash and 3
# bit operations. H100 SXM: 64 INT32 lanes a SM, 132 SMs, 1.98 GHz boost
HASH_OPS = 77
ROW_OPS, ELEM_OPS = 7 * HASH_OPS + 3, HASH_OPS + 3
PEAK_INT32 = 132 * 64 * 1.98e9
# ROADMAP C11: one query's answer at every batch size, per family
C11_BATCHES = (64, 2048, 16_384)
C11_N = 65_536


def _regen_bound(rows: int, d: int, nbytes: int) -> tuple[float, str]:
    """The function's least time: each row regenerated once (the IP kernel
    regenerates a candidate's row twice, once for its norm and once for its
    dot; only its time pays for that)."""
    return bound_ms(nbytes, rows * (ROW_OPS + d * ELEM_OPS), PEAK_INT32)


def regen_vs_plain(dev) -> dict[str, list[dict]]:
    """24a: regen_rows on REGEN_ROWS_M ids and regen_score at B=4096,
    kk=80, d=128, L2 and IP, against their plain versions on the same
    inputs, bit for bit; CUDA-event times of both and the bound."""
    k1, centers, _ = tds._rowkeyed_recipe(CAP_N, D, 1, 64, CAP_SEED, True, dev)
    gen = torch.Generator().manual_seed(CAP_SEED)
    ids = torch.randint(0, CAP_N, (REGEN_ROWS_M,), generator=gen).to(dev)
    cand = torch.randint(0, CAP_N, (REGEN_B, REGEN_KK), generator=gen).to(torch.int32)
    cand[torch.rand((REGEN_B, REGEN_KK), generator=gen) < 0.05] = -1
    cand = cand.to(dev)
    out: dict[str, list[dict]] = {"regen_rows": [], "regen_score": []}
    for metric in (METRIC_L2, METRIC_IP):
        ip = metric == METRIC_IP
        got = rg.regen_rows(k1, centers, ids, normalize=ip)
        want = rg.regen_rows_ref(k1, centers, ids, normalize=ip)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = float((got - want).abs().max())
        del want
        ms = cuda_ms(lambda: rg.regen_rows(k1, centers, ids, normalize=ip))
        plain = cuda_ms(lambda: rg.regen_rows_ref(k1, centers, ids, normalize=ip),
                        reps=3, warmup=1)
        bound, by = _regen_bound(REGEN_ROWS_M, D, REGEN_ROWS_M * (4 + 4 * D))
        case = {"metric": "ip" if ip else "l2", "m": REGEN_ROWS_M, "d": D,
                "bit_equal": equal, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by}
        out["regen_rows"].append(case)
        log(f"[capacity] 24a regen_rows {case}")
        if not equal:
            raise AssertionError(f"regen_rows ({case['metric']}): kernel != plain, "
                                 f"max err {err:.3e}")
        q = (rg.regen_rows(k1, centers, ids[:REGEN_B], normalize=ip)
             + 0.3 * torch.randn((REGEN_B, D), generator=torch.Generator(dev).manual_seed(1),
                                 device=dev))
        if ip:
            q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-30)
        q = q.contiguous()
        got = rg.regen_score(k1, centers, q, cand, metric)
        want = rg.regen_score_ref(k1, centers, q, cand, metric)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        ms = cuda_ms(lambda: rg.regen_score(k1, centers, q, cand, metric))
        plain = cuda_ms(lambda: rg.regen_score_ref(k1, centers, q, cand, metric),
                        reps=3, warmup=1)
        live = int((cand >= 0).sum())
        bound, by = _regen_bound(live, D, cand.numel() * 8 + REGEN_B * D * 4)
        case = {"metric": "ip" if ip else "l2", "B": REGEN_B, "kk": REGEN_KK, "d": D,
                "bit_equal": equal, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by}
        out["regen_score"].append(case)
        log(f"[capacity] 24a regen_score {case}")
        if not equal:
            raise AssertionError(f"regen_score ({case['metric']}): kernel != plain, "
                                 f"max err {err:.3e}")
    del ids, cand, got, want
    torch.cuda.empty_cache()
    return out


def _launched(what: str, *names: str) -> dict:
    """The capacity path's launches since reset_launches; fails on a kernel
    of ``names`` that never launched."""
    got = _capacity_launches()
    for name in names:
        if not got[name]:
            raise AssertionError(f"{what}: {name} never launched")
    return got


def _capacity_launches() -> dict[str, int]:
    return {"regen_rows": rg.regen_rows.launches, "regen_score": rg.regen_score.launches,
            "classmax_scan_split[int8]": sum(
                n for (dt, _), n in cm.classmax_scan_split.form_launches.items()
                if dt == "int8"),
            "classmax2_scan": cm.classmax2_scan.launches,
            "routed_classmax_scan[int8,T32]": k4.routed_classmax_scan.form_launches.get(
                ("int8", 32), 0),
            "routed_classmax_scan[int8,T16]": k4.routed_classmax_scan.form_launches.get(
                ("int8", 16), 0)}


def _timed_serve(run, nq: int) -> tuple:
    """One warm-up call, then the counts at 0 and one timed call: (result,
    qps, launches)."""
    run()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, nq / (time.perf_counter() - t0), _capacity_launches()


def capacity_flat(dev) -> dict:
    """24b and 24c: bench's capacity_split_1m shape through SplitFlatIndex
    and the ext table through FastFlatIndex, both re-ranked from
    regenerated rows."""
    out = {}
    reset_launches()
    t0 = time.perf_counter()
    sds = tds.device_rowkeyed_split_dataset(n=CAP_1M, dim=D, num_queries=CAP_NQ,
                                            seed=CAP_SEED, gt_k=10, comp_dtype="int8",
                                            device=dev)
    torch.cuda.synchronize()
    build_launches = _launched("24b ingestion", "regen_rows")
    sidx = SplitFlatIndex.from_parts(sds.comp_dev, sds.aux_dev, sds.n, dim=D,
                                     row_source=sds.row_source)
    pre = sidx.preload(sds.queries, batch_size=CAP_NQ)
    (ids, _), qps, launches = _timed_serve(lambda: sidx.search(
        sds.queries, 10, kb=64, batch_size=CAP_NQ, preloaded=pre), CAP_NQ)
    recall = recall_at_k(ids, sds.ground_truth, 10)
    out["split_1m"] = {"seconds_build": time.perf_counter() - t0, "recall@10": recall,
                       "qps": qps, "launches": launches, "build_launches": build_launches,
                       "knobs": sidx._resolve_knobs(64, 0, None, None, False)}
    log(f"[capacity] 24b capacity_split_1m (int8, kb=64, batch {CAP_NQ}): "
        f"{json.dumps(out['split_1m'])}")
    if recall < CAP_MIN_RECALL:
        raise AssertionError(f"24b: recall@10 {recall:.4f} < {CAP_MIN_RECALL}")
    _launched("24b", "classmax_scan_split[int8]", "regen_score")
    del sidx, pre
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.perf_counter()
    eds = tds.device_rowkeyed_ext_dataset(n=CAP_1M, dim=D, num_queries=CAP_NQ,
                                          seed=CAP_SEED, gt_k=10, device=dev)
    torch.cuda.synchronize()
    build_launches = _launched("24c ingestion", "regen_rows")
    fidx = FastFlatIndex.from_ext(eds.ext_dev, eds.n, dim=D, row_source=eds.row_source)
    pre = fidx.preload(eds.queries, batch_size=CAP_NQ)
    (ids, _), qps, launches = _timed_serve(lambda: fidx.search(
        eds.queries, 10, batch_size=CAP_NQ, preloaded=pre), CAP_NQ)
    recall = recall_at_k(ids, eds.ground_truth, 10)
    eps = tds.streaming_eps_recall(eds, ids, 10)
    out["ext_1m"] = {"seconds_build": time.perf_counter() - t0, "recall@10": recall,
                     "eps_recall@10": eps, "qps": qps, "launches": launches,
                     "build_launches": build_launches,
                     "knobs": fidx._resolve_knobs(0, 0, None, None, False)}
    log(f"[capacity] 24c ext 1M (FastFlat auto knobs, batch {CAP_NQ}): "
        f"{json.dumps(out['ext_1m'])}")
    if recall < CAP_MIN_RECALL:
        raise AssertionError(f"24c: recall@10 {recall:.4f} < {CAP_MIN_RECALL}")
    if not launches["classmax2_scan"] or not launches["regen_score"]:
        raise AssertionError(f"24c: a kernel of the path never launched: {launches}")
    del fidx, pre
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    SHARDED_SCAN["26e_flat"] = sharded_capacity_flat(sds, eds, dev)
    SHARDED_SCAN["26e_flat"]["seconds"] = time.perf_counter() - t0
    del sds, eds
    torch.cuda.empty_cache()
    return out


def capacity_routed(dev) -> dict:
    """24d, the capacity-routed-41.9m cell: the routed build of 41,943,040
    row-keyed rows with no resident base, its scorer crosscheck and peak
    memory, then 2048 queries at each of CAP_ROUTES and once with the
    fallback spill."""
    t0 = time.perf_counter()
    k1, centers, queries = tds._rowkeyed_recipe(CAP_N, D, CAP_NQ, 64, CAP_SEED, True, dev)
    q_np = queries.cpu().numpy()
    row_source = (k1, centers)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stages = []

    def say(m):
        stages.append(m)
        log(f"[capacity] {m}")

    reset_launches()
    index, gt = build_routed_split(CAP_N, D, row_source=row_source, queries=q_np, gt_k=11,
                                   log=say, **CAP_BUILD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    build_launches = _launched("24d build", "regen_rows")
    table_gb = (index.comp.numel() * index.comp.element_size()
                + index.aux_r.numel() * 4 + index.gid.numel() * 4) / 1e9
    log(f"[capacity] 24d build: {build_s:.2f} s, C={index.C} cap={index.cap} tables "
        f"{table_gb:.3f} GB, peak allocated {peak / 1e9:.3f} GB (before the build "
        f"{mem0 / 1e9:.3f} GB; the f32 base {F32_BASE_BYTES / 1e9:.3f} GB), "
        f"base resident: {index.base_dev is not None}")
    if peak >= F32_BASE_BYTES or index.base_dev is not None:
        raise AssertionError(f"24d: peak {peak / 1e9:.3f} GB reaches the f32 base's "
                             f"{F32_BASE_BYTES / 1e9:.3f} GB")
    t1 = time.perf_counter()
    cross = tds.rowkeyed_scorer_crosscheck(row_source, q_np)
    log(f"[capacity] 24d scorer crosscheck: overlap {cross:.4f} "
        f"({time.perf_counter() - t1:.1f} s)")
    if cross <= CAP_MIN_CROSSCHECK:
        raise AssertionError(f"24d: scorer crosscheck {cross:.4f} <= {CAP_MIN_CROSSCHECK}")
    mm = margin_mask(q_np, None, gt, 10, row_source=row_source)
    out = {"n": CAP_N, "C": index.C, "cap": index.cap, "table_gb": table_gb,
           "build_s": build_s, "peak_gb": peak / 1e9, "crosscheck": cross,
           "margin_share": float(mm.mean()), "build_launches": build_launches,
           "stages": stages, "routes": {}}
    pre = index.preload(q_np, batch_size=CAP_NQ)
    for name, p, P, T in CAP_ROUTES + (("spill 16:192:32", 16, 192, 32),):
        fb = 0.5 if name.startswith("spill") else 0.0
        (ids, _), qps, launches = _timed_serve(lambda: index.search(
            q_np, 10, probes=p, shared=P, tile=T, batch_size=CAP_NQ, preloaded=pre,
            with_dists=False, fallback=fb), CAP_NQ)
        r = {"recall@10": recall_at_k(ids, gt, 10),
             "eps_recall@10": recall_at_k_eps_regen(ids, q_np, row_source, gt, 10),
             "margin_recall@10": recall_at_k(ids[mm], gt[mm], 10),
             "coverage": index.last_coverage, "spilled": index.last_fallback,
             "qps": qps, "launches": launches}
        out["routes"][name] = r
        log(f"[capacity] 24d {name}: {json.dumps(r)}")
        if not launches["routed_classmax_scan[int8,T32]"] or not launches["regen_score"]:
            raise AssertionError(f"24d {name}: K4 or regen_score never launched")
    gate = out["routes"][CAP_GATE_ROUTE]["recall@10"]
    if gate < CAP_MIN_RECALL:
        raise AssertionError(f"24d: recall@10 {gate:.4f} at {CAP_GATE_ROUTE} < "
                             f"{CAP_MIN_RECALL}")
    profile_run(lambda: index.search(q_np, 10, probes=32, shared=256, tile=32,
                                     batch_size=CAP_NQ, preloaded=pre, fallback=0),
                "capacity-routed-41.9m 32:256:32", CAP_NQ)
    del index, pre
    torch.cuda.empty_cache()
    return out


def _c11_runs(dev) -> dict[str, tuple]:
    """Each family's search at C11_N x 128 rows: (index, run(q, B) -> ids,
    dists, the set of 64 queries, the rows that fill a batch)."""
    ds = synthetic_dataset(n=C11_N, dim=D, num_queries=C11_BATCHES[-1], seed=12,
                           compute_gt=False)
    q64, filler = ds.queries[:64], ds.queries[64:]
    flat = FastFlatIndex(ds.base, device=dev)
    split = SplitFlatIndex(ds.base, comp_dtype="int8", device=dev)
    ivf = IVFIndex(ds.base, num_clusters=256, seed=7, device=dev)
    graph = build_graph(ds.base, HNSWParams(M=16, ef_construction=100),
                        threads=min(os.cpu_count() or 1, 32))
    hnsw = HNSWIndex(graph, device=dev)
    routed = build_routed_split(C11_N, D, base_dev=torch.from_numpy(ds.base).to(dev),
                                cap_target=512, cls=128, seed=3)
    # the routed family grants clusters to a tile: each query fills its own
    # T=16 tile (16 copies), so its grant is its own wishes in any batch
    rep = np.repeat(ds.queries, 16, axis=0)
    return {
        "fastflat": (lambda q, b: flat.search(q, 10, batch_size=b), q64, filler),
        "split_int8": (lambda q, b: split.search(q, 10, batch_size=b), q64, filler),
        "routed": (lambda q, b: routed.search(q, 10, probes=8, tile=16, shared=8,
                                              batch_size=b, fallback=0), rep[:64], rep[64:]),
        "ivf": (lambda q, b: ivf.search(q, 10, probes=16, batch_size=b), q64, filler),
        "hnsw": (lambda q, b: hnsw.search(q, SearchParams(k=10, ef=64), batch_size=b),
                 q64, filler),
    }


def c11_check(dev) -> dict[str, dict]:
    """24e, ROADMAP C11: one set of 64 queries inside batches of 64, 2,048 and
    16,384, per family; equal ids and equal distance bits, else the phase
    fails naming the family and the batch."""
    out = {}
    for family, (run, q64, filler) in _c11_runs(dev).items():
        res = []
        for b in C11_BATCHES:
            q = np.ascontiguousarray(np.concatenate([q64, filler[:b - 64]]))
            ids, dd = run(q, b)
            res.append((ids[:64], np.asarray(dd[:64], np.float32).view(np.uint32)))
        same = {b: bool(np.array_equal(r[0], res[0][0]) and np.array_equal(r[1], res[0][1]))
                for b, r in zip(C11_BATCHES[1:], res[1:])}
        ids_same = {b: bool(np.array_equal(r[0], res[0][0]))
                    for b, r in zip(C11_BATCHES[1:], res[1:])}
        out[family] = {"equal": same, "ids_equal": ids_same}
        log(f"[c11] {family}: equal ids and distance bits against batch 64: {same} "
            f"(ids alone: {ids_same})")
    bad = [f for f, r in out.items() if not all(r["equal"].values())]
    if bad:
        raise AssertionError(f"C11: a query's answer depends on its batch in {bad}")
    torch.cuda.empty_cache()
    return out


def capacity_phase(dev) -> tuple[list[dict], dict]:
    """Phase 24; the regen kernels' entries of the kernel table."""
    t_phase = time.perf_counter()
    cases = regen_vs_plain(dev)
    flat_out = capacity_flat(dev)
    routed_out = capacity_routed(dev)
    t0 = time.perf_counter()
    SHARDED_SCAN["26e_routed"] = sharded_capacity_routed(dev)
    SHARDED_SCAN["26e_routed"]["seconds"] = time.perf_counter() - t0
    c11 = c11_check(dev)
    serve_launches = sum(r["launches"]["regen_score"] for r in flat_out.values()) + sum(
        r["launches"]["regen_score"] for r in routed_out["routes"].values())
    build_launches = sum(r["build_launches"]["regen_rows"] for r in flat_out.values()) + (
        routed_out["build_launches"]["regen_rows"])
    kernels = []
    for name, launches, replaces in (
            ("regen_score", serve_launches, "shine_tpu/ops/distance.py:281"),
            ("regen_rows", build_launches, "shine_tpu/io/device_synth.py:450")):
        main = next(c for c in cases[name] if c["metric"] == "l2")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "shine_tpu_torch/csrc/regen_rows.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "note": ("not a TPU kernel: an XLA fusion in the JAX package; launches: "
                     + ("the re-ranks of phase 24's timed serving runs (24b, 24c, 24d)"
                        if name == "regen_score" else
                        "the builds of phase 24 (24b and 24c ingestion, 24d's routed build)")),
            "cases": cases[name],
        })
    summary = {"flat": flat_out, "routed": {k: v for k, v in routed_out.items()
                                            if k != "stages"}, "c11": c11,
               "seconds": time.perf_counter() - t_phase}
    log(f"[capacity] summary {json.dumps(summary)}")
    log(f"[capacity] phase 24: {summary['seconds']:.1f} s")
    return kernels, summary


# --- phase 27: the sharded builds, 4 shards stacked on the card -----------------

BUILD_S = 4  # shards of every phase-27 mesh
ONLINE_MESH_CAP = 131_072  # 27b: the online index's capacity
ONLINE_MESH_CHUNKS = 2  # 27b: DET_N rows in this many chunks
MESH_FASTBUILD_GAP = 0.01  # 27c's recall against phase 16's pool-0 graph
PHASE27: dict = {}


def _k2_launches() -> dict[str, int]:
    return {n: f[0].launches for n, f in K2_FORMS.items() if f[0].launches}


def _sharded_device_build(ds, mesh, dev) -> dict:
    """27a: device_build_graph over the mesh on the first DET_N rows, bit for
    bit with phase 20's single-card build of them."""
    torch.cuda.synchronize()
    reset_launches()
    t = {}
    t0 = time.perf_counter()
    graph = device_build_graph(ds.base[:DET_N], BUILD, mesh=mesh, timings=t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    _same_graph(graph, DET_GRAPH["single"], f"27a: the mesh build of {DET_N} rows "
                "against phase 20's single-card build")
    halves = {k: t[k] for k in ("plan", "gather", "apply")}
    stages = {k: t.get(k, 0.0) for k in tb.STAGES}
    single = min(DET_GRAPH["seconds"])
    log(f"[sharded-build] 27a device_build_graph(mesh={BUILD_S} stacked) {DET_N} x {D}: "
        f"{wall:.2f} s ({wall / single:.2f}x phase 20's single-card {single:.2f} s), "
        f"{t['rounds']} rounds, {DET_N / wall:.1f} inserts/s; plan "
        f"{halves['plan']:.3f} s, gather {halves['gather']:.3f} s, apply "
        f"{halves['apply']:.3f} s; stages " + " ".join(f"{k}={v:.3f}" for k, v in
                                                       stages.items())
        + f"; launches {launches}; levels, lists and entry point bit-identical with "
        "phase 20's single-card build")
    if min(launches.values()) == 0:
        raise AssertionError(f"27a: a kernel of the path never launched: {launches}")
    return {"seconds": wall, "single_card_s": single, "rounds": t["rounds"],
            "inserts_per_s": DET_N / wall,
            **{f"{k}_s": v for k, v in halves.items()}, "stages": stages,
            "launches": launches}


def _sharded_online(ds, mesh, dev) -> dict:
    """27b: DynamicHNSWIndex over the mesh fed the first DET_N rows in
    ONLINE_MESH_CHUNKS chunks beside a single-card index: equal snapshots
    after each chunk; the ShardedIndex searcher against the prefix's exact
    top-10 and the single searcher's ids."""
    sharded = DynamicHNSWIndex(D, capacity=ONLINE_MESH_CAP, params=BUILD, mesh=mesh)
    single = DynamicHNSWIndex(D, capacity=ONLINE_MESH_CAP, params=BUILD, device=dev)
    chunk = DET_N // ONLINE_MESH_CHUNKS
    chunks = []
    for i in range(ONLINE_MESH_CHUNKS):
        rows = ds.base[i * chunk:(i + 1) * chunk]
        secs = {}
        for name, index in (("single", single), ("sharded", sharded)):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            index.add(rows)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            secs[f"{name}_launches"] = _launches()
        _same_graph(sharded.snapshot(), single.snapshot(),
                    f"27b: the mesh index after chunk {i + 1}")
        log(f"[sharded-build] 27b chunk {i + 1}: {chunk} inserts, single card "
            f"{secs['single']:.2f} s, mesh {secs['sharded']:.2f} s "
            f"({chunk / secs['sharded']:.1f} inserts/s), launches "
            f"{secs['sharded_launches']}; snapshots bit-identical")
        chunks.append(secs)
    base_t = torch.from_numpy(ds.base[:DET_N]).to(dev)
    gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
    gt = gt.cpu().numpy()
    del base_t
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, _ = sharded.searcher().search(ds.queries, SEARCH, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    search_launches = _launches()
    want, _ = single.searcher().search(ds.queries, SEARCH, batch_size=B)
    recall = recall_at_k(ids, gt, 10)
    agree = float((ids == want).mean())
    log(f"[sharded-build] 27b ShardedIndex searcher: recall@10 {recall:.4f} against "
        f"the exact top-10 of the {DET_N}-row prefix (stated {ONLINE_MIN_RECALL}), "
        f"{agree:.5f} of ids equal to the single searcher's (stated "
        f"{SHARD_MIN_AGREE}), {NQ / wall:.1f} QPS, launches {search_launches}")
    if recall < ONLINE_MIN_RECALL or agree < SHARD_MIN_AGREE:
        raise AssertionError(f"27b: recall {recall:.4f}, id agreement {agree:.5f}")
    if not search_launches.get("gather_score"):
        raise AssertionError(f"27b: the sharded searcher launched {search_launches}")
    return {"chunks": chunks, "recall@10": recall, "id_agreement": agree,
            "qps": NQ / wall, "launches": search_launches}


def _sharded_fast_build(ds, gt, mesh, pool0_recall: float, dev) -> tuple[dict, float]:
    """27c: fast_build_graph over the mesh at 1M, the rows not resident: the
    kNN stage of layer 0 (and level 1) through ShardedFastFlatIndex, K2 once a
    shard a batch; recall@10 within MESH_FASTBUILD_GAP of phase 16's pool 0."""
    torch.cuda.synchronize()
    reset_launches()
    t = {}
    t0 = time.perf_counter()
    graph = fast_build_graph(ds.base, BUILD, mesh=mesh, timings=t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = _k2_launches()
    k1 = gather_score.launches
    sweep = -(-N // B)
    log(f"[sharded-build] 27c fast_build_graph(mesh={BUILD_S} stacked) {N} x {D}, rows "
        f"not resident: {wall:.2f} s (stages {t['total']:.2f} s), top_level="
        f"{graph.top_level}; stage seconds: {_stage_line(t)}; components="
        f"{t['components']:.2f}; upper levels={t['upper_levels']:.2f}; K2 launches "
        f"{k2}, gather_score {k1}")
    total = sum(k2.values())
    if total < BUILD_S * sweep or total % BUILD_S or not k1:
        raise AssertionError(f"27c: K2 launched {k2} (not {BUILD_S} a batch of "
                             f"{sweep}), gather_score {k1}")
    _, recall, qps = serve(graph, ds, gt, "f32", dev, what=f"fast_build mesh={BUILD_S}")
    gap = abs(recall - pool0_recall)
    log(f"[sharded-build] 27c recall@10 {recall:.5f} against phase 16's pool 0 "
        f"{pool0_recall:.5f}: gap {gap:.5f} (stated {MESH_FASTBUILD_GAP})")
    if gap > MESH_FASTBUILD_GAP:
        raise AssertionError(f"27c: recall {recall:.5f} against {pool0_recall:.5f}")
    return {"seconds": wall, "levels": t["levels"], "components": t["components"],
            "upper_levels": t["upper_levels"], "launches": dict(k2, gather_score=k1),
            "recall@10": recall, "qps": qps}, wall


def _sharded_cli(data_dir: str, graph_dir: str, cli_runs: dict, mesh, dev) -> dict:
    """27d: the command line's sharded builds on --synthetic 65536:128 (the
    device build bit for bit with phase 22's single-card one; each graph
    stored and served by the library's ShardedIndex to the CLI's recall),
    and on phase 22's files --index auto --shards 4 (26f's FastFlat recall)
    and --megabatch (phase 22's FastFlat recall and K2a launches)."""
    small = synthetic_dataset(n=65_536, dim=D, num_queries=1000, seed=42)
    out = {}
    common = CLI_DEVBUILD + CLI_COMMON + ["--index", "hnsw", *CLI_HNSW, "--shards",
                                          str(BUILD_S)]
    for name, flag, kernels in (("device_build", "--device-build", ("beam_step",)),
                                ("fast_build", "--fast-build", tuple(K2_FORMS))):
        path = os.path.join(graph_dir, f"mesh_{name}.npz")
        doc, launches, _ = run_cli(common + [flag, "--store-index", path],
                                   f"27d --shards {BUILD_S} {flag}")
        graph = load_graph(path)
        if name == "device_build":
            _same_graph(graph, load_graph(os.path.join(graph_dir, CLI_DEVBUILD_GRAPH)),
                        "27d: the CLI's mesh device build against phase 22's")
        else:
            lib = fast_build_graph(small.base, HNSWParams(
                M=BUILD.M, ef_construction=BUILD.ef_construction, seed=42), mesh=mesh)
            _same_graph(graph, lib, "27d: the CLI's mesh fast build against the "
                        "library's")
        ids, _ = ShardedIndex(graph, mesh).search(small.queries, SEARCH, batch_size=B)
        lib_recall = recall_at_k(ids, small.ground_truth, 10)
        got = doc["queries"]["recall"]
        if got != lib_recall or not any(launches.get(k) for k in kernels):
            raise AssertionError(f"27d {name}: recall {got} against the library's "
                                 f"{lib_recall}, launches {launches}")
        out[name] = {"recall": got, "build_ms": doc["build"]["build_time_ms"],
                     "launches": launches}
    data = ["--data-path", data_dir, *CLI_COMMON]
    doc, launches, err = run_cli(data + ["--index", "auto", "--shards", str(BUILD_S),
                                         "--seed", str(SCAN_SEED)],
                                 f"27d --index auto --shards {BUILD_S}")
    want = SHARDED_SCAN["26f_cli"]["fastflat"]["recall"]
    if "-> fastflat" not in err or doc["queries"]["recall"] != want:
        raise AssertionError(f"27d auto: {err.strip()}, recall "
                             f"{doc['queries']['recall']} against 26f's {want}")
    out["auto"] = {"recall": doc["queries"]["recall"], "launches": launches}
    doc, launches, _ = run_cli(data + ["--index", "fastflat", "--megabatch"],
                               "27d --megabatch")
    want = cli_runs["fastflat"]
    if (doc["queries"]["recall"] != want["queries"]["recall"]
            or launches.get("classmax_scan") != want["launches"].get("classmax_scan")):
        raise AssertionError(f"27d megabatch: recall {doc['queries']['recall']}, "
                             f"launches {launches}, against phase 22's {want}")
    out["megabatch"] = {"recall": doc["queries"]["recall"], "launches": launches,
                        "qps": doc["queries"]["queries_per_sec"]}
    log(f"[sharded-build] 27d: every command line run read its reference's recall "
        f"(device build and fast build bit for bit): {json.dumps(out)}")
    return out


def sharded_build_phase(ds, gt, pool0_recall: float, cli_runs: dict, data_dir: str,
                        graph_dir: str, dev) -> None:
    """Phase 27: the sharded builds on BUILD_S shards stacked on the card;
    the numbers land in PHASE27."""
    from shine_tpu_torch.parallel import dryrun_mesh

    t_phase = time.perf_counter()
    mesh = shard_mesh(BUILD_S, device=dev)
    PHASE27["27a"] = _sharded_device_build(ds, mesh, dev)
    PHASE27["27b"] = _sharded_online(ds, mesh, dev)
    torch.cuda.empty_cache()
    PHASE27["27c"], _ = _sharded_fast_build(ds, gt, mesh, pool0_recall, dev)
    torch.cuda.empty_cache()
    PHASE27["27d"] = _sharded_cli(data_dir, graph_dir, cli_runs, mesh, dev)
    t0 = time.perf_counter()
    steps = dryrun_mesh(8)
    torch.cuda.synchronize()
    PHASE27["27e"] = {"seconds": time.perf_counter() - t0, "steps": steps}
    log(f"[sharded-build] 27e dryrun_mesh(8) stacked on the card: every step passed "
        f"in {PHASE27['27e']['seconds']:.2f} s: {json.dumps(steps)}")
    PHASE27["seconds"] = time.perf_counter() - t_phase
    log(f"[sharded-build] phase 27: {PHASE27['seconds']:.1f} s")
    torch.cuda.empty_cache()


def _attach_sharded_builds(kernels: list[dict]) -> None:
    """K1's entries and the K2 forms gain phase 27's launches by run."""
    runs = {"27a_device_build": PHASE27["27a"]["launches"],
            "27b_searcher": PHASE27["27b"]["launches"],
            "27c_fast_build": PHASE27["27c"]["launches"]}
    for i, c in enumerate(PHASE27["27b"]["chunks"]):
        runs[f"27b_chunk{i + 1}"] = c["sharded_launches"]
    for name, r in PHASE27["27d"].items():
        runs[f"27d_{name}"] = r["launches"]
    for k in kernels:
        got = {run: n[k["name"]] for run, n in runs.items() if n.get(k["name"])}
        if got:
            k["sharded_build_launches"] = got


# --- phase 28: the HNSW scale recipe, and rows past element 2^31 ----------------

# 28a: scripts/torch_scale_hnsw.py's own stages at this size and build
SCALE = dict(n=262_144, d=D, M=32, pool=0)
SCALE_EF = 96
# 28b: 2^24 + 4096 rows of d=128: the last 4096 start past element 2^31 of the
# f32, bf16 and int8 rows (and of the packed ext table from row 14,913,081)
TAIL_N, TAIL = (1 << 24) + 4096, 4096
TAIL_Q = 64  # queries, each equal to one tail row
TAIL_W = 16  # the tail's list width
PHASE28: dict = {}


def load_scale_script(name: str = "torch_scale_hnsw"):
    """``scripts/<name>.py`` as a module (its main() not run); the CPU tests
    load the scale scripts through here too."""
    import importlib.util
    import sys

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def scale_recipe(dev) -> dict:
    """28a: the script's run() at SCALE: the data stage, the crosscheck, the
    build through the fused sweep (its stage file written), the checkpoint,
    f32, bf16 and int8 rows served at SCALE_EF; then the build again from the
    stage file, whose levels, lists and entry point must be the first's."""
    script = load_scale_script()
    work = tempfile.mkdtemp(prefix="chip_smoke_scale_", dir=BUILD_DIR)
    try:
        out = os.path.join(work, "scale.jsonl")
        cfg = script.Config(**SCALE, rows=("f32", "bf16", "int8"), efs=(SCALE_EF,),
                            rebuild=True)
        t0 = time.perf_counter()
        recs, first = script.run(cfg, dev, out, work)
        seconds = time.perf_counter() - t0
        again = dataclasses.replace(cfg, rows=(), efs=(), resume=True)
        t0 = time.perf_counter()
        recs2, second = script.run(again, dev, out, work)
        seconds2 = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _same_graph(first, second, "28a: the build resumed from its stage file")
    builds = [next(r for r in rs if r["stage"] == "fastbuild") for rs in (recs, recs2)]
    if builds[0]["resumed"] or not builds[1]["resumed"] or builds[1]["level0_built"]:
        raise AssertionError(f"28a: the second build did not load layer 0 from the stage "
                             f"file: {builds[1]}")
    served = {r["rows"]: r for r in recs if r["stage"] == "hnsw"}
    for rows, r in served.items():
        log(f"[scale] 28a {rows}: recall@10={r['recall10']:.4f} eps={r['recall10_eps']:.4f}"
            f" margin={r['recall10_margin']:.4f} qps={r['qps']:.1f} U={r['U']} "
            f"launches={r['launches']}")
        if r["recall10"] < MIN_RECALL or not r["launches"].get("beam_step"):
            raise AssertionError(f"28a {rows}: recall@10 {r['recall10']:.4f} or beam_step "
                                 f"never launched ({r['launches']})")
    if set(served) != {"f32", "bf16", "int8"}:
        raise AssertionError(f"28a: served {sorted(served)}")
    plan = builds[0]["timings"]["plan"]
    log(f"[scale] 28a {SCALE['n']} x {SCALE['d']}, M={SCALE['M']}, pool 0: build "
        f"{builds[0]['seconds']:.2f} s (launches {builds[0]['launches']}, sweep "
        f"{plan['layout']} batch {plan['batch']} kb {plan['kb']} keep2 {plan['keep2']}), "
        f"again from the stage file {builds[1]['seconds']:.2f} s, equal bit for bit; "
        f"the whole recipe {seconds:.1f} s and {seconds2:.1f} s")
    return {"seconds": seconds + seconds2, "build_s": [b["seconds"] for b in builds],
            "build_launches": builds[0]["launches"], "plan": plan,
            "served": {k: {f: v[f] for f in ("recall10", "recall10_eps", "recall10_margin",
                                             "qps", "U", "launches", "beam_steps")}
                       for k, v in served.items()}}


def _own_ids(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0]
        raise AssertionError(f"28b {what}: {len(bad)} of {len(want)} queries did not find "
                             f"their own row (first: got {got[bad[:4]]}, want {want[bad[:4]]})")


def _tail_lists(tail_ids: torch.Tensor, dev) -> torch.Tensor:
    """(TAIL_N, TAIL_W) layer-0 lists that join only the tail: row t lists the
    tail rows t + 1, t + 38, t + 75, ... (mod the tail); -1 elsewhere."""
    tail0 = TAIL_N - TAIL
    nb = torch.full((TAIL_N, TAIL_W), -1, dtype=torch.int32, device=dev)
    hop = torch.arange(TAIL_W, device=dev) * 37 + 1
    nb[tail0:] = (tail0 + (tail_ids[:, None] - tail0 + hop[None, :]) % TAIL).to(torch.int32)
    return nb


def tail_rows(dev) -> dict:
    """28b: a table of TAIL_N x 128 Gaussian rows on the card and TAIL_Q
    queries equal to rows of its last TAIL; each route must return each
    query's own row first: K2 (FastFlat at the auto knobs, the ext table
    unshuffled), K3 (the split bf16 table at the auto knobs), gather_score on
    candidate lists of tail rows, and the layer-0 loop of beam_step over
    lists that join only the tail, seeded one row before each query's own,
    on f32, bf16 and int8 rows."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = torch.randn((TAIL_N, D), generator=gen, device=dev)
    tail_ids = torch.arange(TAIL_N - TAIL, TAIL_N, device=dev)
    want_t = torch.arange(TAIL_N - 1, TAIL_N - TAIL, -TAIL // TAIL_Q, device=dev)[:TAIL_Q]
    want = want_t.cpu().numpy().astype(np.int32)
    q = base[want_t].contiguous()
    queries = q.cpu().numpy()
    out: dict = {"rows": TAIL_N, "first_tail_element": (TAIL_N - TAIL) * D}
    launches: dict = {}

    reset_launches()
    flat = FastFlatIndex.from_device(base, shuffle=False)
    ids, _ = flat.search(queries, 10, batch_size=TAIL_Q)
    _own_ids("K2 (FastFlat auto)", ids[:, 0], want)
    launches["fastflat"] = _all_launches()
    out["ext_table"] = list(flat.ext.shape)
    del flat
    torch.cuda.empty_cache()

    reset_launches()
    split = SplitFlatIndex.from_device(base, comp_dtype="bf16")
    ids, _ = split.search(queries, 10, batch_size=TAIL_Q)
    _own_ids("K3 (split bf16 auto)", ids[:, 0], want)
    # by form too, as the K3 entries of the kernel table are named
    launches["split_bf16"] = {**_all_launches(), **{
        f"{name}[{dt},keep{2 if k2 else 1}]": n for name, (f, _, _) in K3_FUNCS.items()
        for (dt, k2), n in f.form_launches.items()}}
    del split
    torch.cuda.empty_cache()

    # gather_score on lists of tail rows: each query's own row at a place of
    # its own among 255 other tail rows, against the plain version
    K = 256
    cand = tail_ids[torch.randint(0, TAIL, (TAIL_Q, K), generator=gen, device=dev)]
    cand[torch.arange(TAIL_Q, device=dev), torch.arange(TAIL_Q, device=dev) * 3] = want_t
    cand = cand.to(torch.int32).contiguous()
    q_ext, bias = _extend_query(q, METRIC_L2)
    reset_launches()
    got = gather_score(base, q_ext, bias, cand)
    launches["gather_score"] = _all_launches()
    err = float((got - gather_score_ref(base, q_ext, bias, cand)).abs().max())
    _own_ids("gather_score", cand.gather(1, got.argmin(1, keepdim=True))[:, 0].cpu().numpy(),
             want)
    if err > ATOL:
        raise AssertionError(f"28b gather_score: {err} from its plain version")
    out["gather_score_max_abs_err"] = err

    # the served layer-0 loop, seeded one row before each query's own: only
    # beam_step's scoring of that seed's list can find the own row
    nb = _tail_lists(tail_ids, dev)
    seeds = (TAIL_N - TAIL + (want_t - 1 - (TAIL_N - TAIL)) % TAIL).to(torch.int32)[:, None]
    # int8 rows from the split int8 table: its codes are quantize_rows' and its
    # aux holds -||row||^2 and twice the scale
    qv, aux = pack_split_device(base, METRIC_L2, comp_dtype="int8")
    tables = {"f32": {"vectors": base}, "bf16": {"vectors": base.to(torch.bfloat16)},
              "int8": {"vectors": qv, "row_scl": aux[1] / 2, "row_nrm": -aux[0]}}
    sp = SearchParams(k=10, ef=64, frontier=4).resolved()
    for rows, t in tables.items():
        kw = {"row_scl": t.get("row_scl"), "row_nrm": t.get("row_nrm")}
        reset_launches()
        seed_d = gather_score(t["vectors"], q_ext, bias, seeds.contiguous(), **kw)
        state = th._l0_state(seeds, seed_d, sp)
        th.run_beam_steps(t["vectors"], nb, q_ext, bias, state, sp, **kw)
        launches[f"layer0_{rows}"] = _all_launches()
        _own_ids(f"beam_step on {rows} rows", state[0].ids[:, 0].cpu().numpy(), want)
        if not launches[f"layer0_{rows}"].get("beam_step"):
            raise AssertionError(f"28b {rows} rows: beam_step never launched")
    del tables, qv, aux, base, nb
    torch.cuda.empty_cache()
    out.update(launches=launches, seconds=time.perf_counter() - t_phase)
    log(f"[scale] 28b {TAIL_N} x {D} rows, {TAIL_Q} queries in the last {TAIL} (from "
        f"element {out['first_tail_element']:,}): every route found each query's own row; "
        f"gather_score max_abs_err {err:.3g}; launches {launches}; {out['seconds']:.1f} s")
    return out


def scale_phase(dev) -> dict:
    """Phase 28: 28a and 28b, one [scale] summary line."""
    PHASE28["28a"] = scale_recipe(dev)
    torch.cuda.empty_cache()
    PHASE28["28b"] = tail_rows(dev)
    PHASE28["seconds"] = PHASE28["28a"]["seconds"] + PHASE28["28b"]["seconds"]
    log(f"[scale] summary {json.dumps(PHASE28)}")
    log(f"[scale] phase 28: {PHASE28['seconds']:.1f} s")
    return PHASE28


def _attach_scale(kernels: list[dict]) -> None:
    """Each kernel's entry gains its phase-28 launches by run."""
    runs = {"28a_build": PHASE28["28a"]["build_launches"],
            **{f"28a_{r}": v["launches"] for r, v in PHASE28["28a"]["served"].items()},
            **{f"28b_{r}": v for r, v in PHASE28["28b"]["launches"].items()}}
    for k in kernels:
        got = {run: n[k["name"]] for run, n in runs.items() if n.get(k["name"])}
        if got:
            k["scale_launches"] = got


# --- phase 29: the 10M validation recipe and the skew grid, cut in rows ---------

VALIDATION_N = 250_000  # 253,952 rows once rounded up to 4096
SKEW = dict(n=262_144, stream=2_048, mults=(12,))
VALIDATION_MIN_RECALL = 0.90  # FastFlat at every point, IVF's routed points
SKEW_MIN_RECALL = 0.90  # every cell of multiplier 12
PHASE29: dict = {}


def _zipf_stream(pool: int, alpha: float, size: int) -> np.ndarray:
    """The skew script's stream, recomputed in numpy alone: a Zipf(alpha)
    draw of ranks (numpy's choice with the normalised weights, uniform
    integers at alpha 0) mapped through default_rng(31)'s permutation."""
    rng = np.random.default_rng(7)
    if alpha <= 0:
        ranks = rng.integers(0, pool, size=size)
    else:
        w = 1.0 / np.power(np.arange(1, pool + 1, dtype=np.float64), alpha)
        ranks = rng.choice(pool, size=size, p=w / w.sum())
    return np.random.default_rng(31).permutation(pool)[ranks]


def validation_recipe(dev) -> dict:
    """29a: the validation script's run() at VALIDATION_N; its gates; then
    the shuffle rule above SHUFFLE_MAX_BYTES."""
    from shine_tpu_torch.models import flat as tflat
    from shine_tpu_torch.ops.scan import pack_ext_device

    script = load_scale_script("torch_scale_validation")
    work = tempfile.mkdtemp(prefix="chip_smoke_validation_", dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        recs, ds = script.run(script.Config(n=VALIDATION_N, d=D), dev,
                              os.path.join(work, "validation.jsonl"))
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = ds.n
    runs, served = {}, {}
    for r in recs:
        if r["stage"] == "fastflat":
            what = (f"29a_{r['index']}_kb{r['kb']}_cls{r['cls']}"
                    + ("_keep2" if r["keep2"] else ""))
            launched = any(k.startswith("classmax") for k in r["launches"])
        elif r["stage"] in ("ivf", "ivf_routed"):
            what = (f"29a_ivf_p{r['probes']}" if r["stage"] == "ivf" else
                    f"29a_ivf_routed_{r['probes']}:{r['shared']}:{r['tile']}")
            launched = bool(r["launches"].get("gather_score"))
        else:
            continue
        runs[what] = r["launches"]
        served[what] = {"recall10": r["recall10"], "qps": r["qps"]}
        log(f"[validation] {what}: recall@10={r['recall10']:.4f} "
            f"eps={r['recall10_eps']:.4f} qps={r['qps']:.1f} launches={r['launches']}"
            + (f" coverage={r['coverage']:.4f} spilled={r['fallback_queries']}"
               if r["stage"] == "ivf_routed" else "")
            + (f" scan {r['scan']['ms']:.4f} ms ({r['scan']['x_bound']:.2f}x its bound)"
               if "scan" in r else ""))
        if not r["ids_in_range"]:
            raise AssertionError(f"29a {what}: an id outside [0, {n})")
        if r["stage"] != "ivf" and r["recall10"] < VALIDATION_MIN_RECALL:
            raise AssertionError(f"29a {what}: recall@10 {r['recall10']:.4f} < "
                                 f"{VALIDATION_MIN_RECALL}")
        if not launched:
            raise AssertionError(f"29a {what}: its kernel (K2 or K1) never launched "
                                 f"({r['launches']})")
    if sum(k.startswith(("29a_default", "29a_shuffled")) for k in runs) != len(script.POINTS) + 1:
        raise AssertionError("29a: not every FastFlat point was served")
    build = next(r for r in recs if r["stage"] == "fastflat_build" and r["index"] == "default")
    if not build["shuffled"]:
        raise AssertionError(f"29a: {build['rows_bytes']} bytes of rows, under the "
                             f"limit, were not shuffled")
    limit = tflat.SHUFFLE_MAX_BYTES
    tflat.SHUFFLE_MAX_BYTES = n * D * 4 - 1
    try:
        plain = tflat.FastFlatIndex.from_device(ds.base_dev)
    finally:
        tflat.SHUFFLE_MAX_BYTES = limit
    if plain.perm is not None or not torch.equal(plain.ext, pack_ext_device(
            ds.base_dev, METRIC_L2)):
        raise AssertionError("29a: over SHUFFLE_MAX_BYTES the table is not the rows "
                             "packed in generator order")
    del plain, ds
    torch.cuda.empty_cache()
    log(f"[validation] 29a {n} x {D}: crosscheck "
        f"{next(r for r in recs if r['stage'] == 'gt-crosscheck')['gt_overlap']}; "
        f"over the shuffle limit the table keeps generator order; {seconds:.1f} s")
    return {"seconds": seconds, "n": n, "launches": runs, "served": served}


def skew_recipe(dev) -> dict:
    """29b: the skew script's routed grid at SKEW; its gates."""
    script = load_scale_script("torch_exp_skew")
    cfg = dataclasses.replace(script.Config(), **SKEW)
    work = tempfile.mkdtemp(prefix="chip_smoke_skew_", dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        recs = script.run(cfg, dev, os.path.join(work, "skew.jsonl"))
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cells = [r for r in recs if r["stage"] == "cell"]
    if len(cells) != len(cfg.alphas) * len(cfg.probes) * len(cfg.mults):
        raise AssertionError(f"29b: {len(cells)} cells")
    runs, served = {}, {}
    for r in cells:
        what = f"29b_a{r['alpha']}_p{r['p']}_P{r['P']}"
        runs[what] = r["launches"]
        served[what] = {f: r[f] for f in ("recall10", "coverage", "qps")}
        log(f"[validation] {what}: recall@10={r['recall10']:.4f} "
            f"coverage={r['coverage']:.4f} qps={r['qps']:.1f} launches={r['launches']}")
        want = _zipf_stream(cfg.pool, r["alpha"], cfg.stream)
        if r["stream_digest"] != script.digest(want):
            raise AssertionError(f"29b {what}: the stream is not numpy's")
        if r["mult"] == 12 and r["recall10"] < SKEW_MIN_RECALL:
            raise AssertionError(f"29b {what}: recall@10 {r['recall10']:.4f} < "
                                 f"{SKEW_MIN_RECALL}")
        if not r["launches"].get("routed_classmax_scan"):
            raise AssertionError(f"29b {what}: K4 never launched ({r['launches']})")
    ingest = next(r for r in recs if r["stage"] == "ingest")
    log(f"[validation] 29b {cfg.n} row-keyed rows: C={ingest['C']} cap={ingest['cap']}, "
        f"build {ingest['seconds']:.2f} s; {seconds:.1f} s")
    return {"seconds": seconds, "C": ingest["C"], "cap": ingest["cap"], "launches": runs,
            "cells": served}


def validation_phase(dev) -> dict:
    """Phase 29: 29a and 29b, one [validation] summary line."""
    PHASE29["29a"] = validation_recipe(dev)
    PHASE29["29b"] = skew_recipe(dev)
    torch.cuda.empty_cache()
    PHASE29["seconds"] = PHASE29["29a"]["seconds"] + PHASE29["29b"]["seconds"]
    log(f"[validation] summary {json.dumps(PHASE29)}")
    log(f"[validation] phase 29: {PHASE29['seconds']:.1f} s")
    return PHASE29


def _attach_validation(kernels: list[dict]) -> None:
    """Each kernel's entry gains its phase-29 launches by run."""
    for key, part in (("validation_launches", "29a"), ("skew_launches", "29b")):
        for k in kernels:
            got = {run: n[k["name"]] for run, n in PHASE29[part]["launches"].items()
                   if n.get(k["name"])}
            if got:
                k[key] = got


# --- phase 30: the experiment scripts on phase 5's graph and phase 22's set -----

LATENCY = dict(batches=(1, 64))  # torch_latency_probe.py: bench.py's p50/p99 batches
SWEEP = dict(index=("hnsw",), ef_search=(128,), shards=(8,), zipf=(1.25,),
             cache_ratio=(0.0, 0.10), num_queries=1000, label="phase30")
SWEEP_MIN_RECALL = 0.90
ICI_POINT = dict(alphas=(1.25,), exchanges=(("compact", False),), routes=((None, 0.15),))
ROUTED_POINT = dict(p_locs=(6,))
PHASE30: dict = {}


def _script_run(script, cfg, dev, work: str):
    """A loaded script's run(cfg, dev, out) with its records under
    ``work``; (its return value, seconds)."""
    t0 = time.perf_counter()
    out = script.run(cfg, dev, os.path.join(work, f"{script.__name__}.jsonl"))
    return out, time.perf_counter() - t0


def _latency_twin(script, graph_path: str, data_dir: str, dev) -> dict:
    """30a's witness: the probe's HNSW search (its ``SEARCH``, ``batch_size``
    B) served again on the card and by the CPU twin on the same graph and
    queries at each B; {B: (the card's recall@10, its top-10 overlap with
    the CPU's)}."""
    graph, ds = load_graph(graph_path), load_dataset(data_dir)
    card, cpu = HNSWIndex(graph, device=dev), HNSWIndex(graph, device="cpu")
    out = {}
    for B in LATENCY["batches"]:
        q = ds.queries[:B]
        c_ids, _ = card.search(q, script.SEARCH, batch_size=B)
        a_ids, _ = cpu.search(q, script.SEARCH, batch_size=B)
        out[B] = (recall_at_k(c_ids, ds.ground_truth[:B], 10), recall_at_k(c_ids, a_ids, 10))
    del card
    torch.cuda.empty_cache()
    return out


def latency_check(graph_path: str, data_dir: str, dev, work: str) -> dict:
    """30a: the latency probe on phase 5's graph and phase 22's set at B 1
    and 64: p50/p99 at both, beam_step in every HNSW call, K2 in every
    FastFlat call; at each B the HNSW recall@10 is the card's on a second
    serve of the same search, whose top-10 overlaps the CPU twin's by at
    least MIN_OVERLAP."""
    script = load_scale_script("torch_latency_probe")
    cfg = dataclasses.replace(script.Config(), data_path=data_dir, graph_path=graph_path,
                              **LATENCY)
    recs, seconds = _script_run(script, cfg, dev, work)
    twin = _latency_twin(script, graph_path, data_dir, dev)
    runs, served = {}, {}
    for r in (r for r in recs if r["stage"] == "probe"):
        what = f"30a_{r['engine']}_b{r['batch']}"
        runs[what] = r["launches"]
        served[what] = {k: r[k] for k in ("ms", "p50_ms", "p99_ms", "recall10")}
        log(f"[experiments] {what}: best {r['ms']:.4f} ms, p50 {r['p50_ms']:.4f} ms, "
            f"p99 {r['p99_ms']:.4f} ms, recall@10={r['recall10']:.4f}, busy "
            f"{r['profile']['busy_share']:.3f}, launches a call {r['launches']}")
        kernel = ("beam_step" if r["engine"] == "hnsw" else
                  next((k for k in r["launches"] if k.startswith("classmax")), None))
        if not r["launches"].get(kernel):
            raise AssertionError(f"30a {what}: its kernel never launched ({r['launches']})")
        if not r["p99_ms"] >= r["p50_ms"] > 0:
            raise AssertionError(f"30a {what}: p50 {r['p50_ms']} / p99 {r['p99_ms']}")
        if r["engine"] == "hnsw":
            recall, overlap = twin[r["batch"]]
            served[what]["cpu_overlap"] = overlap
            log(f"[experiments] {what}: top-10 overlap with the CPU twin {overlap:.4f}")
            if r["recall10"] != recall or overlap < MIN_OVERLAP:
                raise AssertionError(f"30a {what}: recall@10 {r['recall10']} ({recall} "
                                     f"served again), overlap with the CPU twin "
                                     f"{overlap:.4f} (at least {MIN_OVERLAP})")
    if len(runs) != 2 * len(LATENCY["batches"]):
        raise AssertionError(f"30a: {len(runs)} probes")
    return {"seconds": seconds, "launches": runs, "served": served}


def sweep_check(graph_path: str, data_dir: str, dev, work: str) -> dict:
    """30b: the sweep script, two children of ``python -m shine_tpu_torch``
    on phase 22's set and phase 5's graph, 8 shards, Zipf 1.25, the
    replica off and at 10%: both exit 0, recall@10 >= SWEEP_MIN_RECALL and
    equal (the replica changes no answer), hit rate 0 and > 0."""
    script = load_scale_script("torch_exp_sweep")
    cfg = script.Config(data_path=data_dir, index_cache=graph_path, **SWEEP)
    (docs, failed), seconds = _script_run(script, cfg, dev, work)
    if failed or len(docs) != 2:
        raise AssertionError(f"30b: failed children {failed}, {len(docs)} documents")
    for d in docs:
        q = d["queries"]
        log(f"[experiments] 30b {d['meta']['label']}: recall={q['recall']} "
            f"qps={q['queries_per_sec']} hit_rate={d['cache']['hit_rate']} "
            f"ici_bytes/q={q['ici_exchange_bytes'] / q['num_queries']:.1f} "
            f"card={d['meta'].get('card')!r}")
    (off, on) = docs
    recall = off["queries"]["recall"]
    if recall < SWEEP_MIN_RECALL or on["queries"]["recall"] != recall:
        raise AssertionError(f"30b: recall {recall} / {on['queries']['recall']}")
    if not off["cache"]["hit_rate"] == 0 < on["cache"]["hit_rate"]:
        raise AssertionError(f"30b: hit rates {off['cache']} / {on['cache']}")
    return {"seconds": seconds, "recall": recall, "hit_rate": on["cache"]["hit_rate"],
            "qps": [d["queries"]["queries_per_sec"] for d in docs]}


def mesh_studies_check(dev, work: str) -> dict:
    """30c: the ICI study at one grid point (compact exchange, 15% replica,
    alpha 1.25): wire bytes, lanes, rounds and hit rate > 0, gather_score
    launched; 30d: the routed sharded study at one P_loc: owned lanes and
    coverage > 0, K4 and regen_score launched."""
    ici = load_scale_script("torch_exp_ici_exchange")
    (row,), ici_s = _script_run(ici, ici.Config(**ICI_POINT), dev, work)
    log(f"[experiments] 30c ici {row['exchange']} {row['routing']} "
        f"{row['cache_ratio']}: recall={row['recall']:.4f} bytes/q="
        f"{row['ici_bytes_per_q']:.1f} lanes/q={row['ici_lanes_per_q']:.2f} "
        f"rounds={row['rpc_rounds']} hit_rate={row['cache_hit_rate']:.4f} "
        f"qps={row['qps']:.1f} launches={row['launches']}; {ici_s:.1f} s")
    if not (row["ici_bytes"] > 0 and row["ici_lanes"] > 0 and row["rpc_rounds"] > 0
            and row["cache_hit_rate"] > 0 and row["launches"].get("gather_score")):
        raise AssertionError(f"30c: a counter or gather_score at 0: {row}")
    routed = load_scale_script("torch_exp_routed_sharded")
    recs, routed_s = _script_run(routed, routed.Config(**ROUTED_POINT), dev, work)
    got = recs[-1]
    log(f"[experiments] 30d routed sharded C={got['C']} P_loc={got['P_loc']}: lanes "
        f"{got['lanes_used']} of {got['lane_window']}, overflow {got['overflow']}, "
        f"coverage {got['coverage']:.4f}, recall@10={got['recall10']:.4f}, "
        f"launches={got['launches']}; {routed_s:.1f} s")
    if not (got["lanes_used"] > 0 and got["coverage"] > 0
            and got["launches"].get("routed_classmax_scan")
            and got["launches"].get("regen_score")):
        raise AssertionError(f"30d: a counter or kernel at 0: {got}")
    return {"seconds": ici_s + routed_s,
            "launches": {"30c_ici": row["launches"], "30d_routed": got["launches"]},
            "ici": {k: row[k] for k in ("recall", "ici_bytes_per_q", "ici_lanes_per_q",
                                        "rpc_rounds", "cache_hit_rate", "qps")},
            "routed": {k: got[k] for k in ("C", "lanes_used", "lane_window", "overflow",
                                           "coverage", "recall10")}}


def experiments_phase(graph_path: str, data_dir: str, dev) -> dict:
    """Phase 30: 30a-d, one [experiments] summary line."""
    work = tempfile.mkdtemp(prefix="chip_smoke_experiments_", dir=BUILD_DIR)
    try:
        PHASE30["30a"] = latency_check(graph_path, data_dir, dev, work)
        PHASE30["30b"] = sweep_check(graph_path, data_dir, dev, work)
        PHASE30["30cd"] = mesh_studies_check(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    PHASE30["seconds"] = sum(PHASE30[p]["seconds"] for p in ("30a", "30b", "30cd"))
    log(f"[experiments] summary {json.dumps(PHASE30)}")
    log(f"[experiments] phase 30: {PHASE30['seconds']:.1f} s")
    return PHASE30


def _attach_experiments(kernels: list[dict]) -> None:
    """Each kernel's entry gains its phase-30 launches by run (30a: one
    call; 30c, 30d: one pass)."""
    runs = {**PHASE30["30a"]["launches"], **PHASE30["30cd"]["launches"]}
    for k in kernels:
        got = {run: n[k["name"]] for run, n in runs.items() if n.get(k["name"])}
        if got:
            k["experiments_launches"] = got


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    check_precision()

    t0 = time.perf_counter()
    # g++ builds the graph builder while nvcc builds the kernels (one
    # process a source or part, at once); then the native graph builds on
    # all cores but one, beside the rest of nvcc and phases 3-4, 7, 14-17,
    # 20 and 21, which do not read it
    threads = max(min((os.cpu_count() or 1) - 1, 32), 1)
    pool = ThreadPoolExecutor(3)
    gxx = pool.submit(native.load)
    kernels_built = pool.submit(_build.load)
    ds = synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=SEED, compute_gt=False)
    log(f"[data] {N} x {D}, {NQ} queries: {time.perf_counter() - t0:.2f} s (beside "
        "the builds)")
    gxx.result()
    log(f"[build] native builder {native.lib_path()}: ready after "
        f"{time.perf_counter() - t0:.2f} s")

    def native_graph():
        t = time.perf_counter()
        return build_graph(ds.base, BUILD, threads=threads), time.perf_counter() - t

    graph_built = pool.submit(native_graph)
    kernels_built.result()
    log(f"[build] kernel library {_build.lib_path()}: nvcc "
        f"{_build.build_seconds:.2f} s" if _build.build_seconds is not None
        else f"[build] kernel library {_build.lib_path()}: already built")
    for line in _build.build_log.splitlines():  # registers and spills
        if "entry function" in line or "Used" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    t0 = time.perf_counter()
    base_t = torch.from_numpy(ds.base).to(dev)
    gt, _ = exact_knn(base_t, torch.from_numpy(ds.queries).to(dev), 10)
    torch.cuda.synchronize()
    gt = gt.cpu().numpy()
    del base_t
    log(f"[hnsw] exact fp32 ground truth on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    flat = FastFlatIndex(ds.base, device=dev)
    torch.cuda.synchronize()
    log(f"[flat] FastFlatIndex build (shuffle, pack {tuple(flat.ext.shape)} "
        f"on the card): {time.perf_counter() - t0:.2f} s")
    plan = flat_route_plan(flat)
    shapes: dict[int, list[int]] = {}
    for cls, kb in [(p[3], p[4]) for p in plan] + list(K2_SHAPES):
        if kb not in shapes.setdefault(cls, []):
            shapes[cls].append(kb)

    k1_cases = kernel_vs_twin(ds.base, ds.queries, dev)
    k2_cases, library_ms = k2_vs_twin(ds.base, ds.queries, dev, shapes)
    k2_launches, flat_served = serve_flat(flat, ds, gt, plan)
    profile_batch(flat, ds.queries, "fastflat auto")
    k56_cases, k56_library_ms = blockmax_vs_twin(ds.base, ds.queries, dev)
    blockmax_served = serve_blockmax(flat, ds, gt)
    builds = build_phases(ds, gt, dev)
    devbuild = device_build_phase(ds, gt, dev)
    online, build_step = online_phase(ds, dev)

    t0 = time.perf_counter()
    graph, build_s = graph_built.result()
    pool.shutdown()
    log(f"[hnsw] native build M={BUILD.M} efc={BUILD.ef_construction} "
        f"threads={threads}: {build_s:.2f} s (beside nvcc and phases 3-4, 7, 14-17, "
        f"20 and 21; waited {time.perf_counter() - t0:.2f} s after them), top_level="
        f"{graph.top_level}, upper vertices={int((graph.levels > 0).sum())}")
    # the host is free again: phase 12's set is made beside the phases
    # before it, and the checks that run the CPU twins run now
    routed_set = ThreadPoolExecutor(1)
    routed_ds = routed_set.submit(synthetic_dataset, n=RN, dim=D, num_queries=NQ,
                                  seed=SEED, compute_gt=False)
    routed_set.shutdown(wait=False)
    flat_end_to_end(ds, flat)
    blockmax_end_to_end(ds, flat)
    del flat
    torch.cuda.empty_cache()
    small_build_cpu_vs_card(dev)
    int_build_cpu_vs_card(dev)
    step_launches = 0
    native_served = {}
    for rows in ("f32", "bf16"):
        launches, recall, qps = serve(graph, ds, gt, rows, dev)
        step_launches += launches
        native_served[rows] = (recall, qps)
        torch.cuda.empty_cache()
    host_oracle(graph, ds, gt, dev)
    draws_on_card(dev)
    step_cases, descent = beam_step_phase(graph, ds, gt, dev)
    hnsw_end_to_end(graph, ds, dev)
    # phase 22 serves this graph and the set from files
    os.makedirs(BUILD_DIR, exist_ok=True)
    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=BUILD_DIR)
    graph_path = os.path.join(cli_dir, "native.npz")
    t0 = time.perf_counter()
    save_graph(graph, graph_path)
    log(f"[cli] native graph saved: {time.perf_counter() - t0:.2f} s")
    del graph
    torch.cuda.empty_cache()
    log(f"[build] native graph (phase 5), f32: recall@10={native_served['f32'][0]:.4f} "
        f"qps={native_served['f32'][1]:.1f} after {build_s:.2f} s of build")
    devbuild_parity(devbuild, native_served["f32"][0])
    k3_kernels, split_served = split_phases(ds, gt, dev)
    try:
        ivf = ivf_phase(ds, gt, dev)
        ds.ground_truth = gt  # the exact top-10 on the card
        data_dir = os.path.join(cli_dir, "sift_shape")
        t0 = time.perf_counter()
        save_dataset(ds, data_dir)
        log(f"[cli] set saved: {time.perf_counter() - t0:.2f} s")
        cli_runs = cli_phase(ds, gt, graph_path, data_dir, {
            "hnsw": (("eq", native_served["f32"][0]), native_served["f32"][1], 5),
            "hnsw_scan_build": (("eq", builds["pool0"]["recall@10"]),
                                builds["pool0"]["qps"], "16, pool 0"),
            "fastflat": (("eq", flat_served["auto"][0]), flat_served["auto"][1],
                         "7, auto"),
            "split": (("ge", CLI_MIN_RECALL), split_served[("int8", "auto")][1],
                      "10, int8 auto"),
            "routed": (("ge", CLI_MIN_RECALL), None, None),
            "auto_zipf": (("ge", FLAT_MIN_RECALL), flat_served["auto"][1], "7, auto"),
            "hnsw_device_build": (("ge", CLI_MIN_RECALL), None, None),
            "ivf": (("eq", ivf["fine"][IVF_E2E_PROBES]["recall"]),
                    ivf["fine"][IVF_E2E_PROBES]["qps"], f"23, probes {IVF_E2E_PROBES}"),
            "ivf_routed": (("eq", ivf["fine_routed_cli"]["recall"]),
                           ivf["fine_routed_cli"]["qps"],
                           "23, search_routed on the fine layout"),
        }, dev)
        sharded = sharded_phase(ds, gt, graph_path, data_dir,
                                cli_runs["flat"]["queries"]["recall"], dev)
        sharded_scan_phase(ds, gt, flat_served, split_served, ivf, data_dir, dev)
        sharded_build_phase(ds, gt, builds["pool0"]["recall@10"], cli_runs, data_dir,
                            cli_dir, dev)
        del ds, gt
        k4_kernels = routed_phases(dev, routed_ds)
        regen_kernels, _ = capacity_phase(dev)
        scale_phase(dev)
        validation_phase(dev)
        experiments_phase(graph_path, data_dir, dev)  # phase 5's graph, phase 22's set
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)

    main_k1 = k1_cases[0]  # f32 rows, L2: the HNSW slice's own row type
    main_step = step_cases[0]
    kernels = [{
        "name": "beam_step",
        "route": "cuda",
        "source": "shine_tpu_torch/csrc/gather_score.cu",
        "replaces": "shine_tpu/ops/pallas_gather.py:136",
        "launches": step_launches,
        "max_abs_err": max(c["max_abs_err"] for c in step_cases),
        "ms": main_step["ms"],
        "plain_ms": main_step["plain_ms"],
        "bound_ms": main_step["bound_ms"],
        "bound_by": main_step["bound_by"],
        "library_ms": None,
        "note": ("one layer-0 step of the JAX loop body (pallas_gather.py's row "
                 "gather, the scoring, beam_merge); launches: phase 5's f32 and "
                 "bf16 passes, gated no-ops included; times: one mid-search step "
                 "at B=4096"),
        "cases": step_cases,
        "build_launches": {"device_build": devbuild["launches"]["beam_step"],
                           "online": online["launches"]["beam_step"]},
        "build_step": build_step[0],
        "build_step_upper": build_step[1],
    }, {
        "name": "gather_score",
        "route": "cuda",
        "source": "shine_tpu_torch/csrc/gather_score.cu",
        "replaces": "shine_tpu/ops/pallas_gather.py:136",
        "launches": descent["gather_score_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
        "ms": main_k1["ms"],
        "plain_ms": main_k1["plain_ms"],
        "bound_ms": main_k1["bound_ms"],
        "bound_by": main_k1["bound_by"],
        "library_ms": None,
        "note": ("launches: the descent entry's pass (its greedy walk and first "
                 "distance); the dense entry's path runs beam_step alone; on the "
                 "card it also scores every exact re-rank (rerank_topk) and IVF's "
                 "probed rows (ops/distance.py:pair_dots), counted in their phases"),
        "cases": k1_cases,
        "build_launches": {"device_build": devbuild["launches"]["gather_score"],
                           "online": online["launches"]["gather_score"]},
        "sharded_launches": {r: v["gather_score_launches"]
                             for r, v in sharded["routes"].items()},
    }]
    for route, _, name, cls, kb in plan:
        # the numbers at the shape whose launches the entry reports
        kb = kb if "topk" in name else None
        at = [c for c in k2_cases[name] if (c["cls"], c["kb"]) == (cls, kb)]
        main_k2 = next(c for c in at if c["metric"] == "l2")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "shine_tpu_torch/csrc/classmax2_scan.cu",
            "replaces": K2_FORMS[name][2],
            "launches": k2_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in at),
            "ms": main_k2["ms"],
            "plain_ms": main_k2["plain_ms"],
            "bound_ms": main_k2["bound_ms"],
            "bound_by": main_k2["bound_by"],
            "library_ms": library_ms,
            "flat_route": route,
            "cls": cls,
            "kb": kb,
            "cases": k2_cases[name],
        })
    for name, (_, _, replaces, source) in K56_FORMS.items():
        main_k56 = next(c for c in k56_cases[name] if c["metric"] == "l2")
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": blockmax_served["launches"] if name == "blockmax_scan" else 0,
            "max_abs_err": max(c["max_abs_err"] for c in k56_cases[name]),
            "ms": main_k56["ms"],
            "plain_ms": main_k56["plain_ms"],
            "bound_ms": main_k56["bound_ms"],
            "bound_by": main_k56["bound_by"],
            "library_ms": k56_library_ms,
            "build_launches": {b: builds[b]["launches"].get(name, 0) for b in builds},
            "cases": k56_cases[name],
        }
        if name == "blockmax_scan":
            entry.update({"flat_route": "blockmax", "kb": blockmax_served["kb"],
                          "recall@10": blockmax_served["recall@10"],
                          "qps": blockmax_served["qps"]})
        else:
            entry["note"] = ("no path of the JAX package calls blockmax_scan2 (only its "
                             "own test does), so no path of the port launches it: 0 on "
                             "every served path; held against its twin in phase 14")
        kernels.append(entry)
    kernels += k3_kernels + k4_kernels + regen_kernels
    for k in kernels:  # the class-max sweeps of the builds
        if k["name"] in K2_FORMS:
            k["build_launches"] = {b: builds[b]["launches"].get(k["name"], 0)
                                   for b in builds}
    _attach_sharded(kernels)
    _attach_sharded_builds(kernels)
    _attach_scale(kernels)
    _attach_validation(kernels)
    _attach_experiments(kernels)
    SHARDED_SCAN["seconds"] = sum(v for k, v in SHARDED_SCAN.items() if k.endswith("_s")) \
        + SHARDED_SCAN["26d"]["seconds"] + SHARDED_SCAN["26e_flat"]["seconds"] \
        + SHARDED_SCAN["26e_routed"]["seconds"]
    log(f"[sharded-scan] summary {json.dumps(SHARDED_SCAN, default=str)}")
    log(f"[sharded-scan] phase 26: {SHARDED_SCAN['seconds']:.1f} s")
    log(f"[build] summary {json.dumps(builds)}")
    log(f"[devbuild] summary {json.dumps({'device_build': devbuild, 'online': online})}")
    log(f"[sharded-build] summary {json.dumps(PHASE27)}")
    log(f"[e2e] {len(E2E_SECONDS)} end-to-end checks of {E2E_QUERIES} queries (CPU "
        f"twins and card): {sum(E2E_SECONDS):.1f} s")
    log(f"[total] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
