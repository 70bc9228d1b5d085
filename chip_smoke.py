#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`lightgbm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: HIGGS 10.5M x 28, MSLR
                                     # 2.27M x 137

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: nvcc compiles every CUDA source of the port for sm_90a, one
   process per source, all started together (kernel B1,
   ``lightgbm_tpu_torch/ops/csrc/histogram.cu``; kernels B2-B4,
   ``lightgbm_tpu_torch/ops/csrc/aligned.cu``; B5,
   ``histogram_words.cu``; B6, ``rank.cu``; the prototypes P1-P3,
   ``proto.cu``), each kernel's registers, stack and spills from ptxas
   printed by name; then ``cuobjdump -sass`` of the aligned library's
   histogram kernel (B4, B2's smaller children), printed whole, and the
   count of each atomic opcode in it and in B1's and B5's two kernels
   each: it fails on a compare-and-swap loop (``ATOMS.CAST.SPIN``, an
   f32/f64/u64 shared-memory add on sm_90a) in the aligned kernel or in
   B1's or B5's f32 kernel (``hist_fixed_kernel``,
   ``words_fixed_kernel``); their f64 kernels keep f64 shared sums and
   are exempt;
3. kernel vs plain: the histogram kernel B1 against its plain PyTorch
   twin on the card at the main path's shapes (10.5M x 28), at 63 and 255
   bins, over the contiguous root and over gathered leaves of half the
   rows, 20k rows, 16,385 rows (two row tiles) and 1 row; f64 must be
   equal, f32 counts equal and grad/hess within 1e-5 of the leaf's sum
   of |g| (|h|), the largest |difference| over that sum printed for
   every check; then f32 and f64 on a payload with NaN, +Inf and -Inf in
   g and h (root and the 20k child), cell by cell against the twin. At
   the root it times the kernel, the twin and one ``index_add_`` over a
   prebuilt flat index (the yardstick, never called by the port), f32
   and f64, and it times the f32 kernel on the gathered leaves beside
   its byte bound and a sector bound (32-byte sectors: 1.75 a 28-byte
   row, one for its gh);
4. leaf-wise path: ``train`` (``tpu_grow_mode=leafwise``) ->
   ``Booster.predict`` / ``model_to_string`` on synthetic HIGGS-shaped
   data (10.5M x 28, 500k holdout, the recipe of
   ``bench.py::synth_higgs``), 255 leaves, 5 rounds at max_bin 63 and 3
   at 255; the kernel launch counts are zeroed just before each run and
   read just after; holdout AUC must exceed 0.6 and the card's
   predictions must match a CPU predict of the same model text;
   one more round at max_bin 63 runs under ``torch.profiler`` and prints
   the device's busy share, the kernels that take the most time and B1's
   device ms and launches by kernel name, which must equal the round's
   calls of the histogram (one launch a call; the profiler can lose one
   kernel record of a round);
5. aligned path: the same data and params through ``train`` with the
   default ``tpu_grow_mode=auto``, which must take the aligned engine and
   say so in the log; launches of B2-B4 per tree, speculative rounds per
   tree and fallbacks; holdout AUC above 0.6 and within 2e-3 of the
   leaf-wise run's; one profiled round at each bin count, which also
   prints the device time and launches of each kernel of aligned.cu
   (B2's partition and child histograms apart; so does the MSLR aligned
   round of phase 10) and B2's partition launches a ``move_pass`` call:
   the partition kernel must launch once a call (one memset beside it);
6. aligned kernels vs plain: one aligned tree at each bin count, in the
   COMPACT layout and in the STANDARD layout (``tpu_force_big_n``), with
   the engine's kernel calls recorded: the root's histogram pass, the
   root's move and the move of the round with the most split blocks (and
   that round's count pass), replayed through each kernel and its plain
   twin on the card: counts equal, moved records equal on the rows the
   new layout covers, histogram counts equal and g/h within 1e-5 x the
   slot's sum of |g| (|h|), the largest |difference| over that sum
   printed for each check (the fixed-point sums are not bit-equal to the
   twins' f64 sums); B2's partition alone timed beside the twin's
   partition and its byte bound, with its launches a call from phase
   5's profiled round (a profiler window of a few calls alone loses
   records); on
   STANDARD records B4 once more with NaN, +Inf and
   -Inf written into the grad/hess lanes, cell by cell against the twin;
   each kernel timed beside its twin, its byte bound and, for B4, one
   ``index_add_``; then B2's smaller-child histograms of the widest round
   alone (the histogram kernel over the moved records and the children's
   chunk map), checked, timed beside the twin, the bound and one
   ``index_add_``; B3 (STANDARD) timed as its launch alone (with a warm
   and a cold L2: ``cold_ms`` reads 256 MB before each launch) and as its
   wrapper, and one kernel a call (no zeroing) counted in a captured CUDA
   graph of the wrapper;
7. big-n path: an aligned run with ``tpu_force_big_n`` (STANDARD records,
   the exact i32 count pass, kernel B3) at max_bin 63, 3 rounds, and one
   profiled round (B3's launches must equal its calls);
8. f64 determinism: small f64-histogram leaf-wise and level
   (``tpu_grow_mode=level``) runs on the card and on the CPU must write
   the same trees;
9. lambdarank kernel vs plain: kernel B6
   (``lightgbm_tpu_torch/ops/csrc/rank.cu``) against its twin on the
   MSLR-shape queries (the recipe of ``bench.py::synth_mslr``, 2.27M rows
   in queries of 80-159 documents, random scores), on long queries (1 to
   5,000 documents), and both under ``tpu_rank_sigmoid_bins=1024`` (on
   the card ``auto`` tables the queries of at most the tile's 512
   documents: every MSLR query, the long set's short ones): g and h
   within 1e-5 x max|g| (max|h|), timed beside the twin and the bound;
   one launch a call, and two calls bit-equal;
10. ranking path: lambdarank at the MSLR shape (2.27M x 137, 255 bins,
   255 leaves, ``min_data_in_leaf`` 50) through ``train`` under ``auto``
   (4 rounds; it must take the aligned engine on EXT records) and pinned
   leaf-wise (2 rounds), the kernel counts zeroed just before each run
   and read just after, the plain twins of B2, B4 and B6 counted too (a
   call fails the run); NDCG@10 over the queries of the first 200,000
   rows (the protocol of ``bench.py::run_mslr``): the two runs' at 3
   rounds within 5e-3 of each other and both above an all-zero score's;
   one profiled round each (the aligned one with phase 5's partition
   launch check);
11. EXT kernels vs plain: phase 6 on the inputs of one aligned
   lambdarank tree at the MSLR shape (255 bins, ``gh_off`` 1), the
   NaN/Inf check of B4 included;
12. level kernel vs plain: kernel B5
   (``lightgbm_tpu_torch/ops/csrc/histogram_words.cu``) on the inputs of
   one level tree at the HIGGS shape, 63 and 255 bins: the root (one
   segment of 10.5M rows) and the round with the most smaller children
   (one segment each, one launch), its segment count printed: ``f32``
   counts equal and g/h within 1e-5 x each segment's sum of |g| (|h|),
   max |d| / sum printed, ``f64`` bit-equal to the twin; both again on a
   payload with NaN, +Inf and -Inf in g and h, cell by cell against the
   twin; f32 and f64 timed beside the twin, the byte bound and one
   ``index_add_``;
13. level path: ``train`` with ``tpu_grow_mode=level`` on phase 4's data
   and params (5 rounds at 63 bins, 3 at 255); the log must name the
   level path, B5's launches are zeroed before and read after, a call of
   B5's plain twin fails the run; rounds and executed splits per tree,
   fallbacks, each level build timed on its own; holdout AUC above 0.6
   and within 2e-3 of the leaf-wise run's; the card's predictions
   against a CPU predict; one profiled round at 63 bins (with B1's and
   B5's device ms and launches by kernel name: its trees fall back to
   leaf-wise; each kernel's launches must equal its calls). Then the same
   at 63 bins with ``max_depth`` 8, where the speculation covers every
   tree: no tree may fall back, and the AUC must be within 2e-3 of the
   aligned engine's on the same params; one profiled round, B5's
   launches equal to its calls;
14. prototype kernels: the port's measurement harnesses through their
   entry points at their own sizes, ``lightgbm_tpu_torch.tools.
   proto_aligned.main`` (10,485,760 rows, chunks of 256 and 512: its
   correctness check, P1 ``slot_hist`` at four configurations, P2
   ``move``) and ``proto_roll.main`` (P3 ``ring_stage``, both variants,
   over 20,000 chunks of 512), the counts zeroed just before and read
   just after, the twins counted (a call fails the run); then each of
   the four kernel functions against its twin at those sizes (P1: counts
   equal, g/h within 1e-5 x the slot's sum of |g|; P2 and P3
   bit-equal), timed beside the twin, the bound and, for P1, one
   ``index_add_``; P2 timed as its launch alone and as its wrapper (with
   the params' host check), one memset and one kernel a call counted in
   a captured CUDA graph; P3 timed as its launch alone with a warm and a
   cold L2 and as its wrapper, one kernel and no memset a call counted
   in a captured CUDA graph (after the timing); P1 once more at (256, 4)
   on payloads of random bits (NaN and Inf among them), held against its
   twin cell by cell;
15. categorical splits at the airline-delay shape of szilard/benchm-ml
   (`synth_airline`: 10,000,000 + 500,000 holdout rows, Month,
   DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest categorical,
   DepTime and Distance numerical; 255 leaves, max_bin 255, the default
   categorical parameters), the binning timed with the six columns
   categorical and all numerical, every run with the plain twins of
   B1-B5 counted (a call fails it) and its categorical nodes, rounds,
   executed splits and fallbacks per tree printed: (a) ``train`` under
   ``auto`` (10 rounds), which must take the aligned engine, say so in
   the log, grow categorical nodes and route by a bitset in B2, with a
   holdout AUC above 0.6 and above the same run's on the columns as
   numbers, the card's predictions against a CPU predict, one profiled
   round (B2's partition one launch a call); (b) leaf-wise, 3 rounds,
   AUC within 2e-3 of (a)'s at 3 rounds; (c) level at ``max_depth`` 8,
   10 rounds, no fallback, AUC within 2e-3 of ``auto``'s at
   ``max_depth`` 8 (both grow the same leaf-wise trees; (a)'s deeper
   trees reach another AUC); (d)
   ``tpu_force_big_n``, 3 rounds, B3 counting by a bitset, its launches
   equal to its calls in a profiled round; (e) phase 6's replay on one
   airline tree, COMPACT (the root's and the widest round's moves) and
   STANDARD (the widest round's move and count pass), through the
   kernels and their twins: counts equal, moved records equal, the
   children's histograms within 1e-5 x sum |g|; B2's partition alone and
   B3's launch alone (warm and cold L2) and wrapper timed beside the
   twin and the byte bound, one memset and one kernel (B2) and one
   kernel (B3) a call from a captured CUDA graph;
16. bagging and the boosting variants on phase 4's data (HIGGS 10.5M x
   28, 500k holdout, 255 leaves, max_bin 63), every run with the kernel
   counts zeroed just before and read just after, its card predictions
   against a CPU predict of its model text, holdout AUC above 0.6: (a)
   ``auto`` with ``bagging_fraction`` 0.8, ``bagging_freq`` 1, 10 rounds,
   which must take the aligned engine (COMPACT, the bag in meta bit 31,
   B3 driving the layout) and say so; rounds, executed splits and
   fallbacks per tree, B3 launches per tree, the median iteration; one
   profiled round (busy share, launches, syncs), the host's bag draw and
   `set_bag` timed; AUC at 5 rounds within 2e-3 of a leaf-wise bagged run
   of 5 rounds; (b) balanced bagging (0.6 / 0.8), 5 rounds, aligned; (c)
   ``tpu_force_big_n`` with bagging, 3 rounds (STANDARD, the f32 bag
   lane); (d) GOSS, 12 rounds at ``learning_rate`` 0.1 (iterations 10-11
   sample), (e) DART, 3 rounds, (f) RF (``bagging_fraction`` 0.632), 3
   rounds, each on the leaf-wise path, RF's model text with
   ``average_output``; at max_bin 255 a bagged ``auto`` run of 3 rounds.
   Then the bag branch of B4 (the root) and of B2's smaller-child
   histograms (the widest round) against their twins on one bagged tree,
   COMPACT at 63 and 255 bins, STANDARD at 63, and EXT (a bagged
   lambdarank tree at the MSLR shape, after phase 11): counts equal, g/h
   within 1e-5 x the slot's in-bag sum of |g| (|h|); B4 again over three
   slots with one slot's rows all out of the bag and, on lane payloads,
   NaN and Inf in out-of-bag rows (skipped, as by the twin); each timed
   beside the unbagged route on the same records, the twin, the byte
   bound and one ``index_add_`` over the in-bag rows; B3 on COMPACT
   records (63 and 255 bins) against its twin, its launch alone (warm and
   cold L2) and wrapper timed;
17. multiclass at the shape of UCI Covertype (`synth_covtype`, seed 17:
   581,012 rows, a 10% holdout, 7 cover types at their published shares,
   ten numerical columns in their published ranges, Wilderness_Area (4
   codes) and Soil_Type (40) categorical; 255 leaves, learning rate 0.1,
   ``min_data_in_leaf`` 20), every run with the kernel counts (and the
   class kinds' apart) zeroed just before and read just after, its path
   read from the log, [N, 7] finite predictions (softmax rows summing to
   1), the card's against a CPU predict of its model text, holdout
   multi_logloss and multi_error: (a) softmax under ``auto`` at 63 bins,
   3 rounds, which must take the aligned engine in its "prob" lanes
   with 7 builds an iteration, every B2 and B4 launch a class kind;
   rounds per tree and fallbacks, the median iteration and one profiled
   round (busy share, launches, syncs); (b) the same at 255 bins, 2
   rounds, not profiled; (c) leaf-wise, 1 round: (a)'s metrics at 1
   round within 2e-3 of (c)'s; (d) one-vs-all under ``auto`` ("score" lanes), 2
   rounds; (e) softmax with ``bagging_fraction`` 0.8 every round, 2
   rounds, and one-vs-all so, 2 rounds: the bag bit and B3 driving the
   layout; (f) ``tpu_grow_mode=level`` at ``max_depth`` 8, 2 rounds; (g)
   f64 leaf-wise at 20,000 rows, 3 rounds: the card's tree sections are
   the CPU's. Then, on the same table drawn at 10,485,760 rows (63
   bins), one iteration of each of softmax and one-vs-all, unbagged and
   bagged, with the engine's kernel calls recorded: B4's class-lane root
   pass and B2's smaller-child class-lane histograms of the widest round
   against their twins (counts equal, g/h within 1e-5 x the slot's sum
   of |g|), B2's partition of that round at W = 24 (K = 7) and of the
   root on K = 31 records of the same rows (W = 72, its lanes staged in
   turns), the moved records equal the twin's, and B3 on the bagged
   K-class records against its twin; each timed beside the twin, the
   byte bound and, for the histograms, one ``index_add_``;
18. quantized histograms, forced splits, CEGB and early stopping (run
   where their data is: (a) after phase 3, (b) and (c) beside phase 4 at
   63 bins, (d) after phase 8): (a) B1's integer branch
   (``hist_int_kernel<int8_t>``, ``<int16_t>``) against its twin at the
   HIGGS shape (10,485,760 x 28), 63 and 255 bins, int8 and int16
   payloads of ``quantize_gh``, over the root and a gathered leaf of
   20,000 rows: bit-equal; warm and cold ms, one kernel and no memset a
   call (a captured CUDA graph), the twin, one int64 ``index_add_`` and
   the byte bound; the kernel's SASS atomics, which must hold no
   compare-and-swap loop; (b) ``tpu_quant_hist=on`` at 16 and 8 bits,
   leaf-wise on phase 4's data (255 leaves, 63 bins), 3 rounds each, the
   counts zeroed just before and read just after: B1's integer launches,
   no f32 one, the median iteration, holdout AUC within 2e-3 of phase
   4's f32 run at 3 rounds, one profiled round of the 8-bit run (B1's
   integer kernel once an integer call); a 20,000-row cut whose card predictions match
   the CPU port's within 1e-5 with the same leaf counts, and whether the
   tree sections are equal; (c) a three-level forced-splits JSON on
   HIGGS features with the CEGB split penalty and a coupled penalty a
   feature, leaf-wise on phase 4's data, 3 rounds: every tree starts
   with the forced splits in BFS order; then a 20,000-row f64 cut whose
   card tree sections equal the CPU port's, each tree charging the
   coupled penalty only of the features no earlier tree used; (d) early
   stopping on a 20,000-row cut with a 10,000-row validation set (AUC
   and logloss, ``early_stopping_rounds`` 3, f64 histograms), with and
   without ``first_metric_only``: ``best_iteration`` and ``best_score``
   on the card equal the CPU port's;
19. sparse input and exclusive feature bundling on the one-hot airline
   table of szilard/benchm-ml's one-hot runs (`airline_onehot_csr` of
   phase 15's `synth_airline` rows, Zipf s 1.3: 10,000,000 + 500,000
   rows, DepTime and Distance dense and the six code columns one-hot,
   674 columns in a CSR of 8 entries a row; 255 leaves, max_bin 255):
   the CSR's Dataset times its sparse ingest apart from the bundling
   plan and its application, and logs G and the bundled and unbundled
   bytes; (a) ``auto``, 5 rounds, which must take the aligned engine on
   the bundled records with no fallback, every B2 launch bundled, one
   profiled round; ``tpu_force_big_n``, 3 rounds, every B3 launch
   bundled; leaf-wise, 3 rounds; ``enable_bundle=false`` on the same
   CSR, 3 rounds, whose holdout AUC the bundled ``auto`` run's at 3
   rounds must be within 2e-3 of; every run's median iteration, the
   plain twins counted (a call fails it); (b) B2's partition (the root's
   and the widest round's moves, COMPACT) and B3 (a big-n tree's widest
   round, STANDARD) bundled against their twins on those records:
   moved records and counts bit-equal, the children's histograms within
   1e-5 x sum |g|; each timed warm and cold beside the unbundled
   instantiation on the same records, the twin and the byte bound, one
   call's graph nodes; (c) a 20,000-row cut on the card and on the CPU
   (15 leaves, 63 bins, 3 rounds): f64 leaf-wise tree sections and CSR
   predictions equal, the aligned engine's bundled trees within C.7's
   bound; (d) when the smoke has
   taken less than 1,000 s: the Allstate law of the JAX package's
   tests/test_efb.py at 1,000,000 rows under ``auto``, which must refuse
   the aligned engine for num_features > 1020 and grow leaf-wise, 3
   rounds, G <= 150, finite predictions;
20. the rest of the objectives: (a) at the shape of UCI
   YearPredictionMSD (the `year` dataset of NVIDIA's gbm-bench;
   `synth_year`, seed 19: 463,715 + 51,630 rows x 90 f32 features, a
   release year from 1922 to 2011), 255 leaves and bins: regression_l1,
   quantile (alpha 0.9) and mape on the host `SerialTreeLearner` (B1 its
   histograms), 3 rounds each, one round of the l1 run profiled (B1's
   launches as its calls); huber, fair, poisson, gamma and tweedie under
   ``auto``, 5 rounds each, which must take the aligned engine on
   STANDARD records (real-valued labels) with no fallback; huber
   leaf-wise, 3 rounds; every run's learner, median iteration, holdout
   default metric and the card's predictions against a CPU predict of
   its model text; (b) beside phase 4 at 63 bins: xentropy under
   ``auto``, 5 rounds, on COMPACT records with its kind computed in B4
   and B2's children, no fallback, holdout AUC within 2e-3 of phase 5's
   binary run at 5 rounds; xentlambda, 3 rounds, on the builder the gate
   picks (EXT records from 1M rows); huber, fair, poisson, gamma, tweedie
   and xentropy 2 rounds each under ``auto`` (COMPACT), the second
   iteration's kernel calls recorded, each kind's launches counted; (c)
   on those records B4's root and B2's smaller-child histograms of the
   widest round with each kind against the twin (counts equal, NaN and
   Inf where the twin has them, finite g/h within 1e-5 x the slot's sum
   of |g|), timed warm and cold beside the binary kind on the same
   records, the twin, one ``index_add_`` and the bound; (d) a
   20,000-row cut of (a)'s table (15 leaves, 63 bins, f64 histograms, 2
   rounds, binned once a device and label), every new objective on the card and on the CPU (xentropy
   and xentlambda on the year scaled to [0, 1]): tree sections and
   predictions equal, l1, quantile and mape on the host learner;
21. uint16 bins, data files, the CLI and `cv` (``--only 21`` runs phases
   1, 2 and 21 alone): (a) B1's uint16 route (``lgbt_hist16_*``) against
   its twin at the HIGGS shape (``synth_higgs``, 10,485,760 x 28) binned
   on the card at max_bin 511, the root and a gathered leaf of 20,000
   rows, f32 (within 1e-5 x the leaf's sum of |g|), f64 and the int8 and
   int16 payloads of ``quantize_gh`` (equal); each timed warm and cold
   beside the twin, one ``index_add_`` and its byte bound (2 B a bin);
   then 200,000 x 3 at 20,000 bins, whose cells take tiles of the bin
   axis, in f32, f64 and int8; (b) the airline table uncut (Zipf s 1.1
   for Origin and Dest: ~274 bins, a uint16 matrix; 10M + 500k x 8, six
   categorical columns, 255 leaves and bins): ``auto`` must log the
   leaf-wise path with "bins not uint8", 3 rounds, every B1 launch on
   the uint16 route, the median iteration, holdout AUC and one profiled
   round; int8 and int16 quantized, a round each; a 20,000-row cut,
   still uint16, f64 leaf-wise on the card and on the CPU, equal; (c)
   the Year shape (`synth_year`, uncut) written as CSV files with a
   header (timed apart), then ``python -m lightgbm_tpu_torch`` in its
   own process: ``task=train`` (l2, 255 leaves and bins, 5 rounds,
   ``valid=`` the test file, ``save_binary``), ``task=predict`` (equal
   to the in-process `Booster.predict`), a train from the ``.bin`` (the
   same model), ``input_model=`` for 2 more rounds (the input model's
   trees first); ``task=convert_model``, compiled with the host C++
   compiler, its raw scores of 1,000 rows within 1e-12 of the model's;
   parse, binning and binary-load s and the median iteration; (d) `cv`,
   3 folds and 3 rounds on the card, then a 20,000-row cut, f64
   leaf-wise, whose result dict on the card equals the CPU's;
22. ingest (``--only 22`` runs phases 1, 2 and 22 alone), after a check
   that the native library (``lightgbm_tpu_torch/native.py``) built from
   ``src/native/`` into ``build/torch_native/``: (a) the Year shape
   (uncut) as CSV files without a header: the native parse equal to the
   numpy parse of the file (NaN equal to NaN), both timed; a two-round
   load on the card, its bins equal to the same load's on the CPU; a
   streamed load (chunks of 65,536 lines), its bins equal to the one-shot
   load's; each load timed alone; 3 rounds of ``auto`` from each, the
   streamed run's trees equal to the one-shot run's; (b) phase 4's HIGGS
   matrix as a float32 ``np.memmap`` through `stream_matrix` (chunks of
   1,048,576 rows) under ``torch.profiler``: bins equal to `from_matrix`'s
   on the card, 3 leaf-wise rounds from each with equal trees, both
   ingests' seconds and the card's idle share during the streamed one;
   (c) ``task=train`` with ``input_model=`` and ``valid=`` on (a)'s files
   for 2 more rounds in its own process: exit 0, a valid l2 line each
   round equal to the in-process `train(init_model=, valid_sets=)` on
   the same loads; (d) a binary model (40 rounds, learning rate 0.5) and
   a 3-class softmax model scored on the card with ``pred_early_stop``
   (freq 2, margin 1.0): equal to a CPU booster's scores of the same
   model text (the native predictor) and unequal to the full scores on
   some row; (e) where pyarrow imports, (a)'s training rows as a Parquet
   file through the columnar load, its bins equal to (a)'s streamed
   bins (else one line says that (e) did not run). With
   ``--prefetch-ab N`` (a)'s streamed load and (b)'s `stream_matrix` also
   run N times each with and without a prefetch thread (the JAX
   package's ``ChunkPrefetcher`` at depth 2, defined here: a thread
   reads chunk k + 1 into memory while the port bins chunk k), in
   alternating order, each timed alone.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM data sheet, f64 outside the tensor cores
KERNEL_SOURCE = "lightgbm_tpu_torch/ops/csrc/histogram.cu"
ALIGNED_SOURCE = "lightgbm_tpu_torch/ops/csrc/aligned.cu"
RANK_SOURCE = "lightgbm_tpu_torch/ops/csrc/rank.cu"
WORDS_SOURCE = "lightgbm_tpu_torch/ops/csrc/histogram_words.cu"
PROTO_SOURCE = "lightgbm_tpu_torch/ops/csrc/proto.cu"
SOURCES = {"histogram": KERNEL_SOURCE, "aligned": ALIGNED_SOURCE,
           "rank": RANK_SOURCE, "histogram_words": WORDS_SOURCE,
           "proto": PROTO_SOURCE}
# cut from 10 and 5 to make room for phase 19, and again for phase 20
ROUNDS = {63: 5, 255: 3}
# the kernels of aligned.cu: B2 move_pass launches the partition (after one
# memset of its scratch) and the smaller children's slot_hist +
# hist_finalize; B4 slot_hist_pass (the tree's root) slot_hist +
# hist_finalize; B3 count_pass count
ALIGNED_KERNELS = ("partition_kernel", "count_kernel", "slot_hist_kernel",
                   "hist_finalize_kernel")
# the kernel of rank.cu (B6): one launch a call
RANK_KERNELS = ("rank_kernel",)
# the kernels of histogram.cu (B1): one launch a call, f32, f64 and the
# integer branch of quantized payloads (int8 and int16 instantiations)
HIST_KERNELS = ("hist_fixed_kernel", "hist_f64_kernel", "hist_int_kernel")
# the kernels of histogram_words.cu (B5): one launch a call, f32 and f64
WORDS_KERNELS = ("words_fixed_kernel", "words_f64_kernel")
MSLR_ROWS, MSLR_FEATURES = 2_270_000, 137     # bench.py stage 3
MSLR_ROUNDS, MSLR_LEAF_ROUNDS = 4, 2     # 6 and 3 before phase 20
NDCG_ROWS = 200_000
# f32 operations of one pair factor (rank.cu::pair_terms, an FMA counted
# as 2, the bf16 roundings not at all): 18 arithmetic operations around
# XLA's exp, whose polynomial is 10 FMAs and 7 more operations, plus the
# two accumulations
OPS_PER_PAIR = 18 + 27 + 2
DEVICE = "cuda:0"              # one card


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_higgs(n: int, f: int, seed: int = 7):
    """Dense float features with a noisy nonlinear boundary (a copy of the
    recipe of bench.py::synth_higgs)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    k = min(7, f // 4)
    for j in range(k):
        X[:, f - 1 - j] = np.abs(X[:, 2 * j] * X[:, 2 * j + 1]) \
            + 0.1 * X[:, f - 1 - j]
    w = rng.standard_normal(f).astype(np.float32) / np.sqrt(f)
    margin = X @ w + 0.5 * np.sin(X[:, 0] * 2.0) * X[:, 1] \
        - 0.4 * (np.abs(X[:, 2]) > 1.0)
    p = 1.0 / (1.0 + np.exp(-margin))
    y = (rng.random(n) < p).astype(np.int8)
    return X, y


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, CUDA events
    around the run, after one warm-up call."""
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


def cold_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn`` in ms with a cold L2:
    before each call a read of 256 MB (five times the H100's 50 MB L2)
    evicts what the last call left there, and CUDA events stand around
    the call alone. A read and not a fill: a fill would leave ~50 MB of
    dirty lines, whose write-back the timed call would pay."""
    flush = torch.ones(1 << 26, dtype=torch.int32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    del flush
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def hist_bound_ms(count: int, f: int, bins: int, itemsize: int,
                  indexed: bool):
    """Least time for one histogram call on this card: each input byte
    read once (the leaf's bins rows, its gh rows, its indices), each
    output byte written once, against 3 adds per (row, feature)."""
    nbytes = count * (f + 8 + (4 if indexed else 0)) + f * bins * 3 * itemsize
    ops = 3 * f * count
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def leaf_gh(torch, n: int, seed: int, device):
    """Logistic-loss gradients and hessians of random margins: the value
    range of the main path's payload."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    margin = torch.randn(n, generator=g)
    label = (torch.rand(n, generator=g) < 0.5).float()
    p = torch.sigmoid(margin)
    return torch.stack([p - label, p * (1 - p)], dim=1).to(device)


# ---------------------------------------------------------------------------
def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    from lightgbm_tpu_torch.utils import cuda_build
    nvcc = cuda_build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc_ver.splitlines()[-1]}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    log(smi.splitlines()[0])
    return {"smi": smi.splitlines()[0], "state": card_state("start")}


def card_state(what: str) -> str:
    """The card's SM and memory clocks, power draw and temperature now
    (``nvidia-smi``), logged: a phase that runs slower on a card that
    clocks lower is told apart from a slower kernel."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True)
    state = (out.stdout.strip().splitlines() or ["not read"])[0] \
        if out.returncode == 0 else f"not read ({out.stderr.strip()})"
    log(f"card at {what}: SM clock, memory clock, power draw, "
        f"temperature: {state}")
    return state


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from lightgbm_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        texts = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    log(f"build: {time.perf_counter() - t0:.3f} s for "
        f"{', '.join(SOURCES.values())} (one nvcc each, in parallel)")
    for name, text in texts.items():
        entry = "?"
        for line in text.splitlines():
            # the kernel's name in its mangled entry: <length><name>E
            m = re.search(r".*\d([a-z][a-z0-9_]*_kernel)[EI]", line)
            if m:
                entry = m.group(1)
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")


def sass_atomics(library: str, kernel: str, whole: bool) -> dict:
    """The count of each atomic opcode in ``cuobjdump -sass`` of
    ``kernel`` in the built library ``library``, the listing printed
    whole if ``whole``."""
    from lightgbm_tpu_torch.utils import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                        "cuobjdump")
    text = subprocess.run([tool, "-sass", cuda_build.library_path(
        library)], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs[1:] if kernel in f.split()[0]]
    if not body:
        raise AssertionError(f"sass: {kernel} not found in the {library} "
                             "library")
    lines = body[0].splitlines()
    if whole:
        log(f"sass of {lines[0].strip()} ({len(lines)} lines):")
        for line in lines:
            log(f"  {line.rstrip()}")
    # every instantiation of a templated kernel (slot_hist_kernel's three
    # bag modes) counts
    ops: dict = {}
    for b in body:
        for op in re.findall(
                r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9_.]+)", b):
            ops[op] = ops.get(op, 0) + 1
    log(f"sass {kernel} atomics ({len(body)} instantiation(s), "
        f"{sum(len(b.splitlines()) for b in body)} lines): {ops}")
    return ops


def phase_sass() -> dict:
    """``cuobjdump -sass`` of the fixed-point histogram kernels: the
    aligned library's (B4, and B2's smaller children), printed whole, B1's
    f32 kernel and B5's; fails if any holds a compare-and-swap loop
    (``ATOMS.CAST.SPIN``, what an f32, f64 or u64 shared-memory atomicAdd
    compiles to on sm_90a). B1's and B5's f64 kernels keep f64 shared sums
    and are exempt; their counts are printed. Returns each kernel's
    counts."""
    ops = {"slot_hist_kernel": sass_atomics("aligned", "slot_hist_kernel",
                                            whole=True),
           "hist_fixed_kernel": sass_atomics("histogram",
                                             "hist_fixed_kernel",
                                             whole=False),
           "hist_f64_kernel": sass_atomics("histogram", "hist_f64_kernel",
                                           whole=False),
           "words_fixed_kernel": sass_atomics("histogram_words",
                                              "words_fixed_kernel",
                                              whole=False),
           "words_f64_kernel": sass_atomics("histogram_words",
                                            "words_f64_kernel",
                                            whole=False)}
    for name in ("slot_hist_kernel", "hist_fixed_kernel",
                 "words_fixed_kernel"):
        if any("CAST.SPIN" in op for op in ops[name]):
            raise AssertionError(f"sass: {name} holds ATOMS.CAST.SPIN")
    return ops


def leaf_abs_sums(torch, gh, idx, begin, count):
    """[1, 2] sum of |g| and |h| over a leaf's rows (the scale of the f32
    histogram tolerance); NaN and Inf add nothing."""
    rows = idx[begin:begin + count].long() if idx is not None \
        else slice(begin, begin + count)
    v = gh[rows]
    return torch.where(torch.isfinite(v), v.abs(), 0.0).sum(0)[None]


def check_parity(torch, H, binm, gh, idx, begin, count, bins, prec,
                 what) -> float:
    """The kernel against its plain twin on the same inputs: f64 equal;
    f32 by `check_hist` (counts equal, grad/hess within 1e-5 x the
    leaf's sum |g| (sum |h|), max |d| / sum printed). Returns the f32 max
    |difference| (0 for f64)."""
    got = H.leaf_histogram(binm, gh, idx, begin, count, bins, prec)
    ref = H.histogram_plain(binm, gh, idx, begin, count, bins, prec)
    torch.cuda.synchronize()
    if prec == "f64":
        if not torch.equal(got, ref):
            d = (got - ref).abs().max().item()
            raise AssertionError(f"f64 histogram differs from the plain twin "
                                 f"({what}, {bins} bins): max |d| {d}")
        return 0.0
    return check_hist(torch, got[None], ref[None], leaf_abs_sums(
        torch, gh, idx, begin, count), f"B1 {what}, {bins} bins, f32")


def row_sectors(f: int) -> float:
    """Mean 32-byte sectors that one row of ``f`` bin bytes at a random
    row of bins [N, f] touches."""
    return sum((o + f - 1) // 32 - o // 32 + 1
               for o in ((r * f) % 32 for r in range(32))) / 32


def phase_parity(torch, dev, rows: int) -> dict:
    """Kernel vs plain twin on the card at the main path's shapes: the
    contiguous root of ``rows`` x 28, a large gathered child (half the
    rows), a small one (20k rows) and leaves of 16,385 rows (two row
    tiles) and 1 row, f32 and f64, at 63 and 255 bins; then f32 and f64
    on a payload with NaN, +Inf and -Inf in g and h (root and the small
    child), cell by cell against the twin. At the root it times the
    kernel, the twin and one ``index_add_``; on the gathered leaves it
    times the kernel beside its byte bound and its sector bound."""
    from lightgbm_tpu_torch.ops import histogram as H
    f, n = 28, rows
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for bins in (63, 255):
        binm = torch.randint(0, bins, (n, f), generator=gen, device=dev,
                             dtype=torch.uint8)
        gh = leaf_gh(torch, n, 5 + bins, dev)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        small = min(20_000, n // 4)
        cases = {"small child": (perm, n // 16 + 7, small),
                 "large child": (perm, n // 4 + 1, n // 2),
                 "two-tile leaf": (perm, n // 8 + 3, min(16_385, n // 4)),
                 "one-row leaf": (perm, n // 3, 1),
                 "root": (None, 0, n)}
        r = {"max_abs_err_f32": 0.0, "gathered": {}}
        for what, (idx, begin, count) in cases.items():
            for prec in ("f32", "f64"):
                err = check_parity(torch, H, binm, gh, idx, begin, count,
                                   bins, prec, what)
                if prec == "f32":
                    r["max_abs_err_f32"] = max(r["max_abs_err_f32"], err)
            if idx is not None:
                def kern():
                    return H.leaf_histogram(binm, gh, idx, begin, count,
                                            bins, "f32")
                ms = cuda_ms(torch, kern, reps=10)
                b_ms = hist_bound_ms(count, f, bins, 4, True)[0]
                sec_ms = (count * (32 * (row_sectors(f) + 1) + 4)
                          + f * bins * 3 * 4) / HBM_BYTES_PER_S * 1e3
                g = r["gathered"][what] = {"rows": count, "ms": ms,
                                           "bound_ms": b_ms,
                                           "sector_bound_ms": sec_ms}
                extra = ""
                if what == "small child":
                    # the main path's gathered leaf: cold, and one
                    # index_add_ over a prebuilt flat index beside it
                    rows_ = idx[begin:begin + count].long()
                    cell = (binm[rows_].long() + torch.arange(
                        f, device=dev) * bins).reshape(-1)
                    pay = torch.cat([gh[rows_], torch.ones(
                        (count, 1), device=dev)], 1)
                    pay = pay[:, None, :].expand(-1, f, -1).reshape(-1, 3)
                    acc = torch.zeros((f * bins, 3), device=dev)
                    g["cold_ms"] = cold_ms(torch, kern)
                    g["library_ms"] = cuda_ms(
                        torch, lambda: acc.index_add_(0, cell, pay), reps=10)
                    g["plain_ms"] = cuda_ms(torch, lambda: H.histogram_plain(
                        binm, gh, idx, begin, count, bins, "f32"), reps=2)
                    del rows_, cell, pay, acc
                    extra = (f", cold {g['cold_ms']:.4f} ms, plain "
                             f"{g['plain_ms']:.4f} ms, index_add_ "
                             f"{g['library_ms']:.4f} ms")
                log(f"time {what} {count} of {n} rows, {bins} bins, f32: "
                    f"kernel {ms:.4f} ms{extra}, bound {b_ms:.4f} ms, "
                    f"sector bound {sec_ms:.4f} ms ({row_sectors(f):.2f} "
                    f"sectors a row + 1 for gh)")
        sizes = ", ".join(str(c[2]) for c in cases.values()
                          if c[0] is not None)
        log(f"parity {bins} bins: f64 equal, f32 counts equal, f32 max |d| "
            f"{r['max_abs_err_f32']:.3e} (root {n}, gathered leaves of "
            f"{sizes} rows)")
        bad = gh.clone()
        pick = torch.randperm(n // 2, generator=gen, device=dev)[
            :max(3, n // 997)]
        i = torch.arange(pick.numel(), device=dev)
        vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                            device=dev)
        bad[pick.long(), i % 2] = vals[i % 3]
        r["nonfinite"] = {}
        for what, (idx, begin, count) in (("small child", cases[
                "small child"]), ("root", cases["root"])):
            for prec in ("f32", "f64"):
                r["nonfinite"][f"{what} {prec}"] = check_hist_nonfinite(
                    torch,
                    H.leaf_histogram(binm, bad, idx, begin, count, bins,
                                     prec)[None],
                    H.histogram_plain(binm, bad, idx, begin, count, bins,
                                      prec)[None],
                    leaf_abs_sums(torch, bad, idx, begin, count),
                    f"B1 NaN/Inf {what}, {bins} bins, {prec}")
        del perm, bad
        for prec, itemsize in (("f32", 4), ("f64", 8)):
            r[f"ms_{prec}"] = cuda_ms(torch, lambda: H.leaf_histogram(
                binm, gh, None, 0, n, bins, prec))
            r[f"plain_ms_{prec}"] = cuda_ms(torch, lambda: H.histogram_plain(
                binm, gh, None, 0, n, bins, prec), reps=2)
            dtype = torch.float32 if prec == "f32" else torch.float64
            cell = (binm.long() + torch.arange(f, device=dev)
                    * bins).reshape(-1)
            pay = torch.cat([gh.to(dtype), torch.ones((n, 1), dtype=dtype,
                                                      device=dev)], 1)
            pay = pay[:, None, :].expand(-1, f, -1).reshape(-1, 3)
            out = torch.zeros((f * bins, 3), dtype=dtype, device=dev)
            r[f"library_ms_{prec}"] = cuda_ms(
                torch, lambda: out.index_add_(0, cell, pay), reps=2)
            del cell, pay, out
            r[f"bound_ms_{prec}"], r[f"bound_by_{prec}"] = hist_bound_ms(
                n, f, bins, itemsize, indexed=False)
            log(f"time root {n}x{f}, {bins} bins, {prec}: kernel "
                f"{r[f'ms_{prec}']:.4f} ms, plain "
                f"{r[f'plain_ms_{prec}']:.4f} ms, index_add_ "
                f"{r[f'library_ms_{prec}']:.4f} ms, bound "
                f"{r[f'bound_ms_{prec}']:.4f} ms "
                f"({r[f'bound_by_{prec}']}, data-sheet 3.35 TB/s)")
        results[bins] = r
        del binm, gh
        torch.cuda.empty_cache()
    return results


def holdout_auc(lt, raw, yte) -> float:
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops.metrics import AUCMetric
    md = Metadata(len(yte))
    md.set_label(yte)
    auc_m = AUCMetric(lt.Config())
    auc_m.init(md, len(yte))
    return auc_m.eval(raw[None, :], None)[0][1]


def train_run(torch, lt, ds, params, rounds, Xte, yte, what) -> tuple:
    """One ``train`` on the card, timed per iteration, with every kernel
    count zeroed just before and read just after; holdout AUC, and the
    card's predictions against a CPU predict of the model text."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    H.reset_launches()
    A.reset_launches()
    t_start = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=rounds, callbacks=[stamp],
                   verbose_eval=False)
    launches = {"B1": H.LAUNCHES["f32"], **A.LAUNCHES,
                **{f"{k}_bundled": v for k, v in A.BUNDLED_LAUNCHES.items()},
                "B5": sum(H.WORDS_LAUNCHES.values()),
                **{f"B1_u16_{k}": v for k, v in H.WIDE_LAUNCHES.items()}}
    trees = bst.num_trees()
    iters = np.diff([t_start] + stamps)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    raw = bst.predict(Xte, raw_score=True)
    pred_s = time.perf_counter() - t0
    auc = holdout_auc(lt, raw, yte)
    text = bst.model_to_string()
    cpu = lt.Booster(model_str=text, params={"device_type": "cpu"})
    sub = Xte[:4000]
    np.testing.assert_allclose(bst.predict(sub, raw_score=True),
                               cpu.predict(sub, raw_score=True),
                               rtol=1e-5, atol=1e-7)
    if not np.all(np.isfinite(raw)) or raw.shape != (len(yte),):
        raise AssertionError(f"{what}: predictions are not finite of shape "
                             f"({len(yte)},)")
    if trees != rounds:
        raise AssertionError(f"{what}: {trees} trees after {rounds} rounds")
    if auc <= 0.6:
        raise AssertionError(f"{what}: holdout AUC {auc} <= 0.6")
    med = statistics.median(iters[1:]) * 1e3 if len(iters) > 1 \
        else float("nan")
    r = {"first_round_s": float(iters[0]), "median_iter_ms": med,
         "launches": launches,
         "launches_per_tree": {k: v / trees for k, v in launches.items()},
         "auc": auc, "peak_bytes": peak, "predict_s": pred_s,
         "model_chars": len(text)}
    return bst, r


def phase_main(torch, lt, X, y, rows: int, max_bin: int) -> tuple:
    """The leaf-wise path at the HIGGS shape (pinned: under ``auto`` the
    card takes the aligned engine). Returns (Dataset, results)."""
    Xtr, ytr, Xte, yte = X[:rows], y[:rows], X[rows:], y[rows:]
    rounds = ROUNDS[max_bin]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": max_bin,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(Xtr, label=ytr, params=params,
                    free_raw_data=False).construct()
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    bst, r = train_run(torch, lt, ds, {**params, "tpu_grow_mode": "leafwise"},
                       rounds, Xte, yte, f"leaf-wise {max_bin}")
    r["binning_s"] = bin_s
    if r["launches"]["B1"] == 0:
        raise AssertionError("the leaf-wise path never launched the "
                             "histogram kernel")
    log(f"main leaf-wise max_bin={max_bin}: binning {bin_s:.3f} s, first "
        f"round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms over {rounds - 1}, B1 launches "
        f"{r['launches']['B1']} ({r['launches_per_tree']['B1']:.1f}/tree), "
        f"holdout AUC {r['auc']:.6f}, predict {len(yte)} rows "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB, model text "
        f"{r['model_chars']} chars")
    if max_bin == 63:
        # phase 18 (b) holds the quantized runs of Q_ROUNDS to this
        r["auc_at_q"] = holdout_auc(lt, bst.predict(
            Xte, raw_score=True, num_iteration=Q_ROUNDS), yte)
        r["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    return ds, params, r


def phase_aligned_main(torch, lt, ds, params, X, y, rows: int, max_bin: int,
                       leaf: dict) -> dict:
    """The aligned engine through ``train`` under the default ``auto``:
    the log must name the aligned path; AUC within 2e-3 of the leaf-wise
    run on the same data and params."""
    from lightgbm_tpu_torch.utils import log as port_log
    Xte, yte = X[rows:], y[rows:]
    rounds = ROUNDS[max_bin]
    lines = []
    port_log.register_callback(lines.append)
    try:
        bst, r = train_run(torch, lt, ds, {**params, "verbosity": 1},
                           rounds, Xte, yte, f"aligned {max_bin}")
    finally:
        port_log.register_callback(None)
    g = bst._gbdt
    if not any("training path: aligned" in ln for ln in lines):
        raise AssertionError(f"the log does not name the aligned path: "
                             f"{lines[:3]}")
    stats = g.aligned_stats
    r["rounds_per_tree"] = [s[0] for s in stats]
    r["splits_executed_per_tree"] = [s[1] for s in stats]
    r["fallbacks"] = g._aligned_eng.fallbacks
    r["auc_leafwise"] = leaf["auc"]
    if r["launches"]["move_pass"] == 0 or r["launches"]["slot_hist_pass"] == 0:
        raise AssertionError(f"the aligned path launched {r['launches']}")
    if abs(r["auc"] - leaf["auc"]) > 2e-3:
        raise AssertionError(f"aligned AUC {r['auc']} is not within 2e-3 of "
                             f"the leaf-wise {leaf['auc']}")
    lp = r["launches_per_tree"]
    r["binning_s"] = leaf["binning_s"]
    log(f"main aligned max_bin={max_bin}: binning (the leaf-wise run's "
        f"Dataset) {leaf['binning_s']:.3f} s, first round "
        f"{r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms over {rounds - 1}, rounds per tree "
        f"{r['rounds_per_tree']}, fallbacks {r['fallbacks']}, launches per "
        f"tree B2 {lp['move_pass']:.1f} B3 {lp['count_pass']:.1f} B4 "
        f"{lp['slot_hist_pass']:.1f} B1 {lp['B1']:.1f}, holdout AUC "
        f"{r['auc']:.6f} (leaf-wise {leaf['auc']:.6f}), predict "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB")
    if rounds >= XENT_ROUNDS:
        # phase 20 (b) holds xentropy's AUC at this many rounds to it
        r["auc_at_xent"] = holdout_auc(lt, bst.predict(
            Xte, raw_score=True, num_iteration=XENT_ROUNDS), yte)
    r["profile"] = profile_round(torch, bst)
    del bst, g
    torch.cuda.empty_cache()
    return r


def phase_big_n(torch, lt, ds, params, X, y, rows: int) -> dict:
    """The STANDARD layout and B3 on a real path: tpu_force_big_n at full
    width, max_bin 63, 3 rounds."""
    bst, r = train_run(torch, lt, ds, {**params, "tpu_force_big_n": True},
                       3, X[rows:], y[rows:], "big-n")
    eng = bst._gbdt._aligned_eng
    if bst._gbdt.train_path != "aligned" or eng.compact:
        raise AssertionError("the big-n run left the STANDARD aligned path")
    if r["launches"]["count_pass"] == 0:
        raise AssertionError("the big-n run never launched count_pass")
    r["rounds_per_tree"] = [s[0] for s in bst._gbdt.aligned_stats]
    log(f"big-n aligned (STANDARD, count pass) max_bin=63: first round "
        f"{r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms, launches {r['launches']}, rounds "
        f"per tree {r['rounds_per_tree']}, holdout AUC {r['auc']:.6f}")
    # B3's launches a call from a profiled round (checked there)
    r["profile"] = profile_round(torch, bst)
    if r["profile"]["count_calls"] == 0:
        raise AssertionError("the big-n profiled round made no count pass")
    del bst, eng
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# bagging and the boosting variants
# ---------------------------------------------------------------------------
BAG = {"bagging_fraction": 0.8, "bagging_freq": 1}


def log_run(what, r) -> None:
    lp = r["launches_per_tree"]
    log(f"{what}: first round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms, launches per tree B1 {lp['B1']:.1f} "
        f"B2 {lp['move_pass']:.1f} (bag {lp['move_pass_bag']:.1f}) B3 "
        f"{lp['count_pass']:.1f} B4 {lp['slot_hist_pass']:.1f} (bag "
        f"{lp['slot_hist_pass_bag']:.1f}), holdout AUC {r['auc']:.6f}, "
        f"predict {r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB")


def bagged_aligned_run(torch, lt, ds, params, rounds, Xte, yte, what,
                       compact: bool) -> tuple:
    """A bagged run under ``auto``: it must take the aligned engine with a
    bag (``compact``: COMPACT's meta bit, else STANDARD's f32 lane), say
    so in the log, and launch the bag branch of B2 and B4 and the count
    pass (B3) on every round; rounds, executed splits and fallbacks per
    tree recorded."""
    from lightgbm_tpu_torch.utils import log as port_log
    lines = []
    port_log.register_callback(lines.append)
    try:
        bst, r = train_run(torch, lt, ds, {**params, "verbosity": 1},
                           rounds, Xte, yte, what)
    finally:
        port_log.register_callback(None)
    g = bst._gbdt
    eng = g._aligned_eng
    if not any("training path: aligned" in ln for ln in lines) \
            or g.train_path != "aligned" or not eng.bagged \
            or eng.compact != compact \
            or eng.bag_lane != (-2 if compact else eng.lanes["bag"]):
        raise AssertionError(f"{what}: took {g.train_path}, not the "
                             "bagged aligned engine of its layout")
    la = r["launches"]
    if not (la["move_pass_bag"] == la["move_pass"] > 0
            and la["slot_hist_pass_bag"] == la["slot_hist_pass"] > 0
            and la["count_pass"] > 0):
        raise AssertionError(f"{what}: launches {la}")
    stats = g.aligned_stats
    r["rounds_per_tree"] = [s[0] for s in stats]
    r["splits_executed_per_tree"] = [s[1] for s in stats]
    r["fallbacks"] = eng.fallbacks
    r["bag_cnt"] = int(g.bag_data_cnt)
    log_run(what, r)
    log(f"  {what}: rounds per tree {r['rounds_per_tree']}, executed "
        f"splits {r['splits_executed_per_tree']}, fallbacks "
        f"{r['fallbacks']}, B3 launches per tree "
        f"{r['launches_per_tree']['count_pass']:.1f}, in-bag rows "
        f"{r['bag_cnt']}")
    return bst, r


def phase_bagging(torch, lt, ds, params, X, y, rows: int) -> dict:
    """Phase 16's runs (a)-(f) on phase 4's data at max_bin 63."""
    Xte, yte = X[rows:], y[rows:]
    t_phase = time.perf_counter()
    res = {}
    # (a) plain bagging under auto: the aligned engine, COMPACT
    bst, a = bagged_aligned_run(torch, lt, ds, {**params, **BAG}, 10, Xte,
                                yte, "bagged auto (a)", compact=True)
    a["auc_at_5"] = holdout_auc(lt, bst.predict(Xte, raw_score=True,
                                                num_iteration=5), yte)
    g = bst._gbdt
    eng = g._aligned_eng
    a["profile"] = profile_round(torch, bst)
    # the bag of one iteration: the host's numpy draw alone, then all of
    # `_bagging` (the draw, the mask and the sorted row ids on the card)
    t0 = time.perf_counter()
    np.random.RandomState(0).choice(rows, int(0.8 * rows), replace=False)
    a["host_choice_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g._bagging(0)
    torch.cuda.synchronize()
    a["bag_draw_s"] = time.perf_counter() - t0
    a["set_bag_ms"] = cuda_ms(torch, lambda: eng.set_bag(g._bag_mask))
    del bst, g, eng
    wb, w = train_run(torch, lt, ds, {**params, **BAG,
                                      "tpu_grow_mode": "leafwise"}, 5, Xte,
                      yte, "bagged leaf-wise")
    if wb._gbdt.train_path != "leafwise":
        raise AssertionError("the bagged leaf-wise run left its path")
    del wb
    log_run("bagged leaf-wise", w)
    a["auc_leafwise_at_5"] = w["auc"]
    if abs(a["auc_at_5"] - w["auc"]) > 2e-3:
        raise AssertionError(f"bagged aligned AUC at 5 rounds "
                             f"{a['auc_at_5']} is not within 2e-3 of the "
                             f"bagged leaf-wise {w['auc']}")
    log(f"  bagged auto (a): AUC at 5 rounds {a['auc_at_5']:.6f} against "
        f"leaf-wise {w['auc']:.6f} (median {w['median_iter_ms']:.1f} ms); "
        f"bag of an iteration {a['bag_draw_s']:.3f} s (numpy's choice "
        f"alone {a['host_choice_s']:.3f} s), set_bag "
        f"{a['set_bag_ms']:.4f} ms on the card")
    res["auto"], res["leafwise"] = a, w
    # (b) balanced bagging; (c) the STANDARD bag lane
    bst, res["balanced"] = bagged_aligned_run(
        torch, lt, ds, {**params, "pos_bagging_fraction": 0.6,
                        "neg_bagging_fraction": 0.8, "bagging_freq": 1}, 5,
        Xte, yte, "balanced bagged auto (b)", compact=True)
    del bst
    bst, res["big_n"] = bagged_aligned_run(
        torch, lt, ds, {**params, **BAG, "tpu_force_big_n": True}, 3, Xte,
        yte, "bagged big-n (c)", compact=False)
    del bst
    # (d)-(f) the variants, leaf-wise
    for key, extra, rounds, cls in (
            ("goss", {"boosting": "goss"}, 12, "GOSS"),
            ("dart", {"boosting": "dart"}, 3, "DART"),
            ("rf", {"boosting": "rf", "bagging_fraction": 0.632,
                    "bagging_freq": 1}, 3, "RF")):
        bst, r = train_run(torch, lt, ds, {**params, **extra}, rounds, Xte,
                           yte, key)
        g = bst._gbdt
        if type(g).__name__ != cls or g.train_path != "leafwise":
            raise AssertionError(f"{key}: {type(g).__name__} took "
                                 f"{g.train_path}")
        if key == "goss" and g.bag_data_indices is None:
            raise AssertionError("GOSS never sampled")
        if key == "rf" and "\naverage_output\n" not in \
                bst.model_to_string():
            raise AssertionError("RF's model text lacks average_output")
        r["bag_cnt"] = int(g.bag_data_cnt)
        if key == "dart":
            r["drops_last"] = len(g.drop_index)
        log_run(f"{key} (leaf-wise)", r)
        res[key] = r
        del bst, g
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"bagging phase (63 bins): {res['phase_s']:.1f} s")
    return res


def phase_bag_parity(torch, lt, ds, params, bag_params: dict, max_bin: int,
                     layout: str) -> dict:
    """The bag branch of B4 and B2's smaller-child histograms, and on
    COMPACT records B3, against their twins on one bagged aligned tree
    (phase 16); each timed beside the unbagged route on the same records,
    the twin, the byte bound and one ``index_add_``."""
    from lightgbm_tpu_torch.ops import aligned as A
    calls = capture_kernel_calls(
        torch, lt, ds, {**params, **bag_params,
                        "tpu_force_big_n": layout == "standard"})
    what = f"bagged, {max_bin} bins, {layout}"
    gh, bl = calls["gh_off"], calls["bag_lane"]
    if (bl == -2) != (layout == "compact") or bl == -1:
        raise AssertionError(f"{what}: the engine passed bag_lane={bl}")
    res = {}
    # ---- B4 with its bag: the root pass
    args = calls["slot_hist_pass"]
    rec, slots, meta, k, F, B, wcnt, bits, grad = args
    nc, W, C = rec.shape
    kw = {"gh_off": gh, "bag_lane": bl}
    err = check_hist(torch, A.slot_hist_pass(*args, **kw),
                     A.slot_hist_pass_plain(*args, **kw),
                     slot_abs_sums(torch, A, rec, slots, meta, k, wcnt, grad,
                                   gh, bl), f"slot_hist_pass root, {what}")
    valid = A._valid_rows(meta, C)
    rows = int(valid.sum())
    inbag = int((valid & A._in_bag(rec, wcnt, bl)).sum())
    # three slots, the third's rows all out of the bag, NaN and Inf in
    # out-of-bag rows of lane payloads: skipped by the kernel and the twin
    three = (torch.arange(nc, device=DEVICE) * 4 // nc).to(torch.int32)
    bad = rec.clone()
    last = (three == 2).nonzero()[:, 0]
    if bl == -2:
        bad[last, wcnt + 1] &= 0x7FFFFFFF
    else:
        bad[last, bl] = 0
    if grad is None:
        oob = valid & ~A._in_bag(bad, wcnt, bl)
        poisoned = poison_gh(torch, bad, wcnt, gh, meta, every=97)
        pay = slice(wcnt + gh, wcnt + gh + 2)
        bad[:, pay] = torch.where(oob[:, None], poisoned[:, pay],
                                  bad[:, pay])
        del poisoned
    got = A.slot_hist_pass(bad, three, meta, 3, F, B, wcnt, bits, grad, **kw)
    check_hist(torch, got, A.slot_hist_pass_plain(
        bad, three, meta, 3, F, B, wcnt, bits, grad, **kw),
        slot_abs_sums(torch, A, bad, three, meta, 3, wcnt, grad, gh, bl),
        f"slot_hist_pass, three slots, one out of the bag, {what}")
    if float(got[2, ..., 2].sum()) != 0.0 or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{what}: an out-of-bag row reached a sum")
    del bad, got
    r = {"max_abs_err": err, "rows": rows, "in_bag_rows": inbag,
         "ms": cuda_ms(torch, lambda: A.slot_hist_pass(*args, **kw)),
         "unbagged_ms": cuda_ms(torch, lambda: A.slot_hist_pass(
             *args, gh_off=gh)),
         "plain_ms": cuda_ms(
             torch, lambda: A.slot_hist_pass_plain(*args, **kw), reps=2),
         "library_ms": hist_library_ms(torch, A, rec, slots, meta, k, F, B,
                                       wcnt, bits, grad, gh, bl)}
    # every valid row's bag word, the in-bag rows' bins and payload (the
    # COMPACT meta word is both)
    pay_lanes = 1 if bl == -2 else 2
    r["bound_ms"], r["bound_by"] = bound(
        rows * 4 + inbag * (wcnt + pay_lanes) * 4 + nc * 2 * 4
        + k * F * B * 3 * 4, 3 * F * inbag)
    res["slot_hist_bag"] = r
    # ---- B2 with its bag: the widest round's move, its children alone
    args = calls["move_wide"]
    err = check_move(torch, A, args, f"move_pass wide, {what}", gh,
                     bag_lane=bl)
    rec, meta, k, w_used = args[0], args[5], args[8], args[13]
    buf = torch.empty_like(rec)
    part = (*args[:8], k, bits, w_used, buf)
    nslot, ncnt = A._move_partition_cuda(*part)
    child = (nslot, ncnt, k, F, B, wcnt, bits, grad)
    _, ref = A.move_pass_plain(*args, gh_off=gh, bag_lane=bl)
    err = max(err, check_hist(
        torch, A._slot_hist_cuda(buf, *child, gh, bl), ref,
        slot_abs_sums(torch, A, buf, nslot, ncnt, k, wcnt, grad, gh, bl),
        f"child histograms alone, wide, {what}"))
    del ref
    mapped = ncnt > 0
    crows = int(ncnt[mapped].sum())
    cvalid = A._valid_rows(ncnt, C) & mapped[:, None]
    cinbag = int((cvalid & A._in_bag(buf, wcnt, bl)).sum())
    r = {"max_abs_err": err, "rows": crows, "in_bag_rows": cinbag,
         "children": int(torch.unique(nslot[mapped]).numel()),
         "ms": cuda_ms(torch, lambda: A._slot_hist_cuda(buf, *child, gh,
                                                        bl)),
         "unbagged_ms": cuda_ms(torch, lambda: A._slot_hist_cuda(
             buf, *child, gh)),
         "plain_ms": cuda_ms(torch, lambda: A.slot_hist_pass_plain(
             buf, *child, gh_off=gh, bag_lane=bl), reps=2),
         "library_ms": hist_library_ms(torch, A, buf, nslot, ncnt, k, F, B,
                                       wcnt, bits, grad, gh, bl)}
    r["bound_ms"], r["bound_by"] = bound(
        crows * 4 + cinbag * (wcnt + pay_lanes) * 4 + nc * 2 * 4
        + k * F * B * 3 * 4, 3 * F * cinbag)
    res["child_hist_bag"] = r
    del buf, nslot, ncnt, child
    # ---- B3 on COMPACT records: the widest round's count pass
    if layout == "compact":
        args = calls["count_wide"]
        got, ref = A.count_pass(*args), A.count_pass_plain(*args)
        if not torch.equal(got, ref):
            raise AssertionError(f"count_pass differs from its twin, {what}")
        meta, ks, k = args[3], args[5], args[6]
        crows = int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
        alone = torch.empty(k, dtype=torch.int32, device=DEVICE)
        r = {"max_abs_err": 0.0, "rows": crows, "chunks": nc,
             "ms": cuda_ms(torch, lambda: A._count_cuda(*args, alone),
                           reps=20),
             "cold_ms": cold_ms(torch, lambda: A._count_cuda(*args, alone)),
             "wrapper_ms": cuda_ms(torch, lambda: A.count_pass(*args),
                                   reps=20),
             "plain_ms": cuda_ms(torch, lambda: A.count_pass_plain(*args),
                                 reps=2),
             "library_ms": None}
        r["bound_ms"], r["bound_by"] = bound(crows * 4 + nc * 5 * 4 + k * 4,
                                             crows)
        res["count_compact"] = r
    for name, r in res.items():
        extra = {key: v for key, v in r.items() if key in (
            "rows", "in_bag_rows", "children", "chunks", "unbagged_ms",
            "cold_ms", "wrapper_ms")}
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"kernel {name} ({what}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |d| "
            f"{r['max_abs_err']:.3e}, {extra}")
    del calls
    torch.cuda.empty_cache()
    return res


def phase_ext_bag(torch, lt, ds, params) -> dict:
    """Phase 16 on EXT records: a bagged lambdarank run under ``auto`` at
    the MSLR shape (2 rounds; the aligned engine with the f32 bag lane),
    then the bag branch of B4 and B2's children on one bagged tree."""
    from lightgbm_tpu_torch.ops import aligned as A
    p = {**params, **BAG, "verbosity": -1}
    A.reset_launches()
    bst = lt.train(p, ds, num_boost_round=2, verbose_eval=False)
    launches = dict(A.LAUNCHES)
    eng = bst._gbdt._aligned_eng
    if bst._gbdt.train_path != "aligned" or not eng.ext \
            or eng.bag_lane != eng.lanes["bag"] \
            or launches["slot_hist_pass_bag"] == 0 \
            or launches["move_pass_bag"] == 0:
        raise AssertionError(f"the bagged MSLR run took "
                             f"{bst._gbdt.train_path}, launches {launches}")
    log(f"bagged MSLR auto (EXT, bag lane {eng.bag_lane} of W {eng.W}): "
        f"launches {launches}")
    del bst, eng
    return {"launches": launches,
            "kernels": phase_bag_parity(torch, lt, ds, params, BAG, 255,
                                        "ext")}


def capture_kernel_calls(torch, lt, ds, params, skip: int = 0) -> dict:
    """One aligned iteration with the engine's kernel calls recorded
    (clones of their inputs): the root's histogram pass, the root's
    move, and the move of the round with the most split blocks among
    those that also copy unsplit blocks, with that round's count pass
    (STANDARD only); ``gh_off`` is the grad lane offset the engine passed
    (EXT: 1), and ``<call>_cbits`` each move's and count's bitset table
    (None without a categorical feature). ``skip`` iterations run first,
    unrecorded (their scores give the recorded one's payloads more than
    the first iteration's few distinct values)."""
    from lightgbm_tpu_torch.models import aligned_builder as AB
    names = ("move_pass", "count_pass", "slot_hist_pass")
    real = {n: getattr(AB, n) for n in names}
    keep, state = {}, {"count": None, "blocks": -1, "on": skip == 0}

    def start(env):
        state["on"] = env.iteration + 1 >= skip

    def clone(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def slot_hist(*args, **kw):
        if not state["on"]:
            return real["slot_hist_pass"](*args, **kw)
        keep.setdefault("slot_hist_pass", clone(args))
        keep.setdefault("gh_off", kw.get("gh_off", 2))
        keep.setdefault("bag_lane", kw.get("bag_lane", -1))
        return real["slot_hist_pass"](*args, **kw)

    def count(*args, **kw):
        if not state["on"]:
            return real["count_pass"](*args, **kw)
        state["count"] = clone(args)
        state["count_cbits"] = clone((kw.get("cbits"),))[0]
        return real["count_pass"](*args, **kw)

    def move(*args, out=None, **kw):
        if not state["on"]:
            return real["move_pass"](*args, out=out, **kw)
        r1, meta, hs, k = args[1], args[5], args[7], args[8]
        blocks = int(torch.unique(hs[(hs & 0xFFFFFF) < k]).numel())
        copies = int(((((r1 >> 16) & 1) == 1)
                      & ((meta & 0xFFFFF) > 0)).sum())
        cbits = clone((kw.get("cbits"),))[0]
        if "move_root" not in keep:
            keep["move_root"] = clone(args)
            keep["move_root_cbits"] = cbits
        elif copies > 0 and blocks >= state["blocks"]:
            keep.pop("move_wide", None)
            keep["move_wide"] = clone(args)
            keep["move_wide_cbits"] = cbits
            keep["count_wide"] = state["count"]
            keep["count_wide_cbits"] = state.get("count_cbits")
            state["blocks"] = blocks
        state["count"] = None
        return real["move_pass"](*args, out=out, **kw)

    for n, fn in zip(names, (move, count, slot_hist)):
        setattr(AB, n, fn)
    try:
        lt.train(params, ds, num_boost_round=skip + 1, verbose_eval=False,
                 callbacks=[start])
    finally:
        for n in names:
            setattr(AB, n, real[n])
    keep["wide_blocks"] = state["blocks"]
    return keep


def slot_abs_sums(torch, A, rec, slot_of_chunk, meta, k, wcnt, grad,
                  gh_off=2, bag_lane=-1):
    """[k, 2] sum of |g| and |h| over the valid (in-bag) rows of each
    slot's chunks (the scale of the histogram tolerance); NaN and Inf add
    nothing."""
    g, h = A._payload(rec, wcnt, grad, gh_off)
    valid = A._valid_rows(meta, rec.shape[2])
    if bag_lane != -1:
        valid = valid & A._in_bag(rec, wcnt, bag_lane,
                                  A._meta_lane(grad, wcnt))

    def fin(x):
        return torch.where(valid & torch.isfinite(x), x.abs(), 0.0)

    per_chunk = torch.stack([fin(g).sum(1), fin(h).sum(1)], dim=1)
    ok = (slot_of_chunk >= 0) & (slot_of_chunk < k)
    out = torch.zeros((k, 2), dtype=torch.float32, device=rec.device)
    out.index_add_(0, slot_of_chunk[ok].long(), per_chunk[ok])
    return out


def check_hist(torch, got, ref, scale, what) -> float:
    """Counts equal, g/h within 1e-5 x the slot's sum of |g| (|h|); logs
    the largest |difference| and the largest over the slot's sum, and
    returns the first."""
    torch.cuda.synchronize()
    if not torch.equal(got[..., 2], ref[..., 2]):
        raise AssertionError(f"{what}: histogram counts differ")
    err = (got[..., :2] - ref[..., :2]).abs()
    lim = scale[:, None, None, :].expand_as(err)
    if bool((err > 1e-5 * lim).any()):
        raise AssertionError(f"{what}: g/h differ beyond 1e-5 x sum|.| "
                             f"(max |d| {err.max().item()})")
    rel = (err.double() / lim.double().clamp_min(1e-300)).max().item()
    log(f"  check {what}: max |d| {err.max().item():.3e}, max |d| / slot "
        f"sum|.| {rel:.3e}")
    return err.max().item()


def poison_gh(torch, rec, wcnt, gh_off, meta, every=997):
    """A copy of ``rec`` with NaN, +Inf and -Inf in the g and h lanes of
    about one valid row in ``every`` (what a user's overflowing objective
    leaves there)."""
    rec = rec.clone()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    valid = (torch.arange(rec.shape[2], device=DEVICE)[None, :]
             < (meta & 0xFFFFF)[:, None]).reshape(-1).nonzero()[:, 0]
    pick = valid[torch.randperm(valid.numel(), generator=gen,
                                device=DEVICE)[:max(3, valid.numel()
                                                    // every)]]
    pay = rec[:, wcnt + gh_off:wcnt + gh_off + 2].view(torch.float32)
    vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                        device=DEVICE)
    i = torch.arange(pick.numel(), device=DEVICE)
    c, r = pick // rec.shape[2], pick % rec.shape[2]
    pay[c, i % 2, r] = vals[i % 3]
    return rec


def check_hist_nonfinite(torch, got, ref, scale, what) -> dict:
    """Counts equal; each g/h cell NaN, Inf (of its sign) or finite where
    the twin's is; finite cells within 1e-5 x the slot's finite sum of
    |g| (|h|)."""
    torch.cuda.synchronize()
    a, b = got[..., :2], ref[..., :2]
    fin = torch.isfinite(b)
    if not torch.equal(got[..., 2], ref[..., 2]) \
            or not torch.equal(a.isnan(), b.isnan()) \
            or not torch.equal(a.isinf(), b.isinf()) \
            or not torch.equal(a[b.isinf()], b[b.isinf()]):
        raise AssertionError(f"{what}: counts or NaN/Inf cells differ from "
                             "the twin's")
    if not bool((~fin).any()):
        raise AssertionError(f"{what}: the twin has no non-finite cell")
    err = torch.where(fin, (a - b).abs(), 0.0).double()
    lim = scale[:, None, None, :].expand_as(err).double()
    if bool((err > 1e-5 * lim).any()):
        raise AssertionError(f"{what}: finite g/h differ beyond 1e-5 x "
                             "sum|.|")
    r = {"nonfinite_cells": int((~fin).sum()),
         "max_abs_err": err.max().item(),
         "max_rel_err": (err / lim.clamp_min(1e-300)).max().item()}
    log(f"  check {what}: {r['nonfinite_cells']} non-finite cells as the "
        f"twin's, finite max |d| {r['max_abs_err']:.3e}, max |d| / slot "
        f"sum|.| {r['max_rel_err']:.3e}")
    return r


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_move(torch, A, args, what, gh_off=2, cbits=None,
               bag_lane=-1, bundled=False) -> float:
    """The move kernel against its twin: records equal on the rows the new
    layout covers (the twin run into two fills marks them) in the used
    lanes; the smaller children's histograms by `check_hist`. ``cbits``:
    the round's bitset table; ``bag_lane``: the bag mode; ``bundled``:
    the bundled branch."""
    rec, meta, hs, k = args[0], args[5], args[7], args[8]
    wcnt, w_used, grad = args[11], args[13], args[14]
    kw = {"gh_off": gh_off, "cbits": cbits, "bag_lane": bag_lane,
          "bundled": bundled}
    out, hist = A.move_pass(*args, **kw)
    ref_a, ref_hist = A.move_pass_plain(*args, out=torch.full_like(rec, -1),
                                        **kw)
    cov = ref_a[:, 0] == A.move_pass_plain(
        *args, out=torch.full_like(rec, -2), **kw)[0][:, 0]
    for u in range(w_used):
        if not torch.equal(out[:, u][cov], ref_a[:, u][cov]):
            raise AssertionError(f"{what}: moved records differ in lane {u}")
    err = check_hist(torch, hist, ref_hist, slot_abs_sums(
        torch, A, rec, hs & 0xFFFFFF, meta, k, wcnt, grad, gh_off,
        bag_lane), what)
    del out, hist, ref_a, ref_hist, cov
    return err


def hist_library_ms(torch, A, rec, slot_of_chunk, meta, k, F, B, wcnt,
                    bits, grad, gh_off, bag_lane=-1) -> float:
    """One ``index_add_`` of (g, h, 1) into [k * F * B, 3] f32 over a
    prebuilt flat index of every (valid, in-bag row of a slot's chunk,
    feature): the yardstick of the slot histogram, never called by the
    port."""
    nc, _, C = rec.shape
    g, h = A._payload(rec, wcnt, grad, gh_off)
    take = A._valid_rows(meta, C) \
        & ((slot_of_chunk >= 0) & (slot_of_chunk < k))[:, None]
    if bag_lane != -1:
        take = take & A._in_bag(rec, wcnt, bag_lane,
                                A._meta_lane(grad, wcnt))
    sel = take.reshape(-1).nonzero()[:, 0]
    pay = torch.stack([g.reshape(-1)[sel], h.reshape(-1)[sel],
                       torch.ones_like(sel, dtype=torch.float32)], dim=1)
    bpw = 32 // bits
    cell = torch.stack([(rec[sel // C, f // bpw, sel % C]
                         >> ((f % bpw) * bits)) & ((1 << bits) - 1)
                        for f in range(F)], dim=1).long() \
        + torch.arange(F, device=rec.device) * B \
        + (slot_of_chunk.long()[sel // C] * F * B)[:, None]
    cell = cell.reshape(-1)
    pay = pay[:, None, :].expand(-1, F, -1).reshape(-1, 3)
    hout = torch.zeros((k * F * B, 3), dtype=torch.float32,
                       device=rec.device)
    ms = cuda_ms(torch, lambda: hout.index_add_(0, cell, pay), reps=2)
    del g, h, sel, pay, cell, hout
    return ms


def phase_aligned_parity(torch, lt, ds, params, max_bin: int,
                         layout: str, path_profile: dict) -> dict:
    """B2/B3/B4 against their twins on the inputs of one real aligned tree
    (HIGGS shape: COMPACT, or STANDARD under ``tpu_force_big_n``; MSLR
    shape: EXT), timed beside the twin, the byte bound and (B4) one
    ``index_add_``; B2's partition alone too, with its launches a call
    from the path's profiled round (``path_profile``, which checked them;
    a profiler window of a few calls alone loses records)."""
    from lightgbm_tpu_torch.ops import aligned as A
    calls = capture_kernel_calls(
        torch, lt, ds, {**params, "tpu_force_big_n": layout == "standard"})
    what = f"{max_bin} bins, {layout}"
    gh = calls["gh_off"]
    if (gh == 1) != (layout == "ext"):
        raise AssertionError(f"{what}: the engine passed gh_off={gh}")
    res = {}
    # ---- B4: the root pass
    args = calls["slot_hist_pass"]
    rec, slots, meta, k, F, B, wcnt, bits, grad = args
    nc, W, C = rec.shape
    err = check_hist(torch, A.slot_hist_pass(*args, gh_off=gh),
                     A.slot_hist_pass_plain(*args, gh_off=gh),
                     slot_abs_sums(torch, A, rec, slots, meta, k, wcnt, grad,
                                   gh),
                     f"slot_hist_pass root, {what}")
    rows = int((meta & 0xFFFFF)[(slots >= 0) & (slots < k)].sum())
    r = {"max_abs_err": err, "rows": rows,
         "ms": cuda_ms(torch, lambda: A.slot_hist_pass(*args, gh_off=gh)),
         "plain_ms": cuda_ms(
             torch, lambda: A.slot_hist_pass_plain(*args, gh_off=gh),
             reps=2),
         "library_ms": hist_library_ms(torch, A, rec, slots, meta, k, F, B,
                                       wcnt, bits, grad, gh)}
    r["bound_ms"], r["bound_by"] = bound(
        rows * (wcnt + 2) * 4 + nc * 2 * 4 + k * F * B * 3 * 4,
        3 * F * rows)
    if layout != "compact":
        # NaN and Inf in the grad/hess lanes, as a user's objective may
        # leave them: the cells where the twin's f64 sums have them
        bad = poison_gh(torch, rec, wcnt, gh, meta)
        r["nonfinite"] = check_hist_nonfinite(
            torch, A.slot_hist_pass(bad, *args[1:], gh_off=gh),
            A.slot_hist_pass_plain(bad, *args[1:], gh_off=gh),
            slot_abs_sums(torch, A, bad, slots, meta, k, wcnt, grad, gh),
            f"slot_hist_pass root on NaN/Inf payloads, {what}")
        del bad
    res["slot_hist_pass"] = r
    # ---- B2: the root's move, then the widest round's
    err = check_move(torch, A, calls["move_root"],
                     f"move_pass root, {what}", gh)
    args = calls["move_wide"]
    err = max(err, check_move(torch, A, args, f"move_pass wide, {what}", gh))
    rec, r1, meta, k, w_used = args[0], args[1], args[5], args[8], args[13]
    cnt = meta & 0xFFFFF
    is_copy = ((r1 >> 16) & 1) == 1
    split_rows = int(cnt[~is_copy].sum())
    copy_chunks = int((is_copy & (cnt > 0)).sum())
    buf = torch.empty_like(rec)
    moved = 2 * (split_rows * w_used * 4 + copy_chunks * w_used * C * 4)
    r = {"max_abs_err": err, "split_blocks": calls["wide_blocks"],
         "split_rows": split_rows, "copy_chunks": copy_chunks,
         "ms": cuda_ms(torch, lambda: A.move_pass(*args, out=buf,
                                                  gh_off=gh)),
         "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
             *args, out=buf, gh_off=gh), reps=2),
         "library_ms": None}
    r["bound_ms"], r["bound_by"] = bound(
        moved + nc * 9 * 4 + k * F * B * 3 * 4, 3 * F * split_rows / 2)
    res["move_pass"] = r
    # ---- B2's partition alone (the twin's: its histograms over no slot)
    part = (*args[:8], k, bits, w_used, buf)
    no_hist = (*args[:8], 0, *args[9:])
    r = {"max_abs_err": 0.0, "split_blocks": calls["wide_blocks"],
         "split_rows": split_rows, "copy_chunks": copy_chunks,
         "launches_per_call": path_profile["partition_launches_per_call"],
         "ms": cuda_ms(torch, lambda: A._move_partition_cuda(*part),
                       reps=20),
         "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
             *no_hist, out=buf, gh_off=gh), reps=2),
         "library_ms": None}
    r["bound_ms"], r["bound_by"] = bound(moved + nc * 9 * 4, 0)
    res["partition"] = r
    # ---- B2's smaller-child histograms alone: the histogram kernel on
    # the widest round's moved records and its children's chunk map
    nslot, ncnt = A._move_partition_cuda(*part)
    child = (nslot, ncnt, k, F, B, wcnt, bits, grad)
    _, ref = A.move_pass_plain(*args, gh_off=gh)
    err = check_hist(torch, A._slot_hist_cuda(buf, *child, gh), ref,
                     slot_abs_sums(torch, A, buf, nslot, ncnt, k, wcnt, grad,
                                   gh),
                     f"child histograms alone, wide, {what}")
    del ref
    mapped = ncnt > 0
    rows = int(ncnt[mapped].sum())
    r = {"max_abs_err": err, "rows": rows, "children": int(
        torch.unique(nslot[mapped]).numel()),
        "ms": cuda_ms(torch, lambda: A._slot_hist_cuda(buf, *child, gh)),
        "plain_ms": cuda_ms(torch, lambda: A.slot_hist_pass_plain(
            buf, *child, gh_off=gh), reps=2),
        "library_ms": hist_library_ms(torch, A, buf, nslot, ncnt, k, F, B,
                                      wcnt, bits, grad, gh)}
    r["bound_ms"], r["bound_by"] = bound(
        rows * (wcnt + 2) * 4 + nc * 2 * 4 + k * F * B * 3 * 4,
        3 * F * rows)
    res["child_hist"] = r
    del buf, nslot, ncnt, child
    # ---- B3: the widest round's count pass (STANDARD)
    if calls.get("count_wide") is not None:
        args = calls["count_wide"]
        got, ref = A.count_pass(*args), A.count_pass_plain(*args)
        if not torch.equal(got, ref):
            raise AssertionError(f"count_pass differs from its twin, {what}")
        meta, ks, k = args[3], args[5], args[6]
        rows = int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
        # the launch alone (its shape and scratch looked up once) and the
        # wrapper; then the work one call enqueues, from a captured graph
        from lightgbm_tpu_torch.utils.launches import graph_launches
        alone = torch.empty(k, dtype=torch.int32, device=DEVICE)
        r = {"max_abs_err": 0.0, "rows": rows, "chunks": nc,
             "ms": cuda_ms(torch, lambda: A._count_cuda(*args, alone),
                           reps=20),
             "cold_ms": cold_ms(torch, lambda: A._count_cuda(*args, alone)),
             "wrapper_ms": cuda_ms(torch, lambda: A.count_pass(*args),
                                   reps=20),
             "plain_ms": cuda_ms(torch, lambda: A.count_pass_plain(*args),
                                 reps=2),
             "library_ms": None}
        graph = graph_launches(lambda: A.count_pass(*args))
        if graph != {"kernels": 1, "memsets": 0, "other": 0}:
            raise AssertionError(f"count_pass enqueued {graph}, not one "
                                 "kernel")
        r["launches_per_call"] = graph["kernels"] + graph["memsets"]
        r["bound_ms"], r["bound_by"] = bound(rows * 4 + nc * 5 * 4 + k * 4,
                                             rows)
        res["count_pass"] = r
    sizes = ("rows", "chunks", "children", "split_blocks", "split_rows",
             "copy_chunks", "launches_per_call", "wrapper_ms", "cold_ms")
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"kernel {name} ({what}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |d| "
            f"{r['max_abs_err']:.3e}, "
            f"{ {k: v for k, v in r.items() if k in sizes} }")
    del calls
    torch.cuda.empty_cache()
    return res


def kernel_times(kernels, names) -> dict:
    """{name: {"ms", "launches"}} of the profiled kernels (ms, count,
    key) whose key holds one of ``names`` as a word."""
    out = {}
    for ms, count, key in kernels:
        for name in names:
            if re.search(rf"\b{name}\b", key):
                a = out.setdefault(name, {"ms": 0.0, "launches": 0})
                a["ms"] += ms
                a["launches"] += count
    return out


def profile_round(torch, bst, hist_names=HIST_KERNELS,
                  words_names=WORDS_KERNELS, aligned_names=ALIGNED_KERNELS,
                  rank_names=RANK_KERNELS) -> dict:
    """One more boosting round under `torch.profiler`: wall time, the
    device's busy and idle share, host-device syncs, the kernels that
    take the most device time, and the device time and launches of each
    kernel of aligned.cu (``aligned_names``), of B1 (``hist_names``), of
    B5 (``words_names``) and of B6 (``rank_names``) by name (read after
    the main path's counts), and the memsets. With this checkout's
    kernels, each of B1's and B5's must launch as often as the round's
    calls of `leaf_histogram` (`histogram_from_words`) on the card in its
    precision (B1's integer kernel as its integer calls), B2's partition
    kernel as often as `move_pass` (one memset
    beside it: two launches a call), B3's count kernel as `count_pass`
    and B6's as `lambdarank_grad`, one lost profiler record aside."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import rank as R
    torch.cuda.synchronize()

    def b1_calls():
        # B1's calls by precision, its uint16 route's in them
        wide = H.WIDE_LAUNCHES
        return {"f32": H.LAUNCHES["f32"] + wide["f32"],
                "f64": H.LAUNCHES["f64"] + wide["f64"],
                "int": sum(H.INT_LAUNCHES.values()) + wide["i8"]
                + wide["i16"]}
    calls = b1_calls()
    wcalls = dict(H.WORDS_LAUNCHES)
    moves = A.LAUNCHES["move_pass"]
    counts = A.LAUNCHES["count_pass"]
    grads = R.LAUNCHES["lambdarank_grad"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = {k: v - calls[k] for k, v in b1_calls().items()}
    wcalls = {k: H.WORDS_LAUNCHES[k] - v for k, v in wcalls.items()}
    moves = A.LAUNCHES["move_pass"] - moves
    counts = A.LAUNCHES["count_pass"] - counts
    grads = R.LAUNCHES["lambdarank_grad"] - grads
    # the profiler's raw events, summed by name here: `key_averages`
    # builds an event tree of every CPU op first, tens of seconds for a
    # round of ~160,000 launches
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms, dev_n, syncs = {}, {}, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            dev_ms[name] = dev_ms.get(name, 0.0) + e.duration_ns() / 1e6
            dev_n[name] = dev_n.get(name, 0) + 1
        elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaMemcpyAsync"):
            syncs += 1
    # kernel names demangled, as `key_averages` gives them
    kernels = sorted(((ms, dev_n[name], torch._C._demangle(name))
                      for name, ms in dev_ms.items()), reverse=True)
    memsets = sum(k[1] for k in kernels if "Memset" in k[2])
    busy_ms = sum(k[0] for k in kernels)
    launches = sum(k[1] for k in kernels)
    log(f"profile one round: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%), {launches} kernel "
        f"launches, {syncs} sync/copy calls")
    for ms, count, key in kernels[:10]:
        log(f"  {ms:9.3f} ms {count:6d}x {key[:90]}")
    aligned = kernel_times(kernels, aligned_names)
    if aligned:
        log("  aligned.cu kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in aligned.items()) + f"; move_pass calls {moves}, "
            f"memsets in the round {memsets}")
    part = aligned.get("partition_kernel", {"launches": 0, "ms": 0.0})
    per_call = (part["launches"] + memsets) / moves if moves else None
    if moves:
        log(f"  B2 partition: {part['launches']} partition_kernel launches "
            f"and {memsets} memsets for {moves} move_pass calls: "
            f"{per_call:.2f} launches a call, {part['ms'] / moves:.4f} ms "
            f"a call")
    count = aligned.get("count_kernel", {"launches": 0, "ms": 0.0})
    if counts:
        log(f"  B3 count: {count['launches']} count_kernel launches for "
            f"{counts} count_pass calls, {count['ms'] / counts:.4f} ms a "
            f"call")
    rank = kernel_times(kernels, rank_names)
    if rank or grads:
        log("  B6 kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in rank.items()) + f"; lambdarank_grad calls "
            f"{grads}")
    hist = kernel_times(kernels, hist_names)
    if hist or any(calls.values()):
        log("  B1 kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in hist.items()) + f"; leaf_histogram calls "
            f"{calls['f32']} f32, {calls['f64']} f64, {calls['int']} "
            "integer")
    words = kernel_times(kernels, words_names)
    if words or any(wcalls.values()):
        log("  B5 kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in words.items()) + f"; histogram_from_words calls "
            f"{wcalls['f32']} f32, {wcalls['f64']} f64")
    # a second kernel a call shows as more launches than calls; the
    # profiler can lose one kernel record in a round of ~90,000 launches
    # (PERF.md, slice 9), so one fewer is let through
    checks = []
    if hist_names == HIST_KERNELS:
        checks += [(hist, calls, HIST_KERNELS)]
    if words_names == WORDS_KERNELS:
        checks += [(words, wcalls, WORDS_KERNELS)]
    if aligned_names == ALIGNED_KERNELS:
        checks += [(aligned, {"one": moves}, ("partition_kernel",)),
                   (aligned, {"one": counts}, ("count_kernel",))]
    if rank_names == RANK_KERNELS:
        checks += [(rank, {"one": grads}, RANK_KERNELS)]
    for times, n_calls, names in checks:
        for prec, name in zip(n_calls, names):
            got = times.get(name, {"launches": 0})["launches"]
            if not n_calls[prec] - 1 <= got <= n_calls[prec]:
                raise AssertionError(f"profiled round: {name} launched "
                                     f"{got} times for {n_calls[prec]} "
                                     f"{prec} calls")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches,
            "syncs": syncs, "memsets": memsets, "aligned_kernels": aligned,
            "move_calls": moves, "partition_launches_per_call": per_call,
            "count_calls": counts,
            "hist_kernels": hist, "hist_calls": calls,
            "words_kernels": words, "words_calls": wcalls,
            "rank_kernels": rank, "rank_calls": grads,
            "top": [[k[2][:90], k[0], k[1]] for k in kernels[:10]]}


def phase_f64(torch, lt) -> int:
    """Small f64-histogram runs on the card and on the CPU, leaf-wise and
    on the level builder: same trees."""
    from lightgbm_tpu_torch.ops import histogram as H
    X, y = synth_higgs(20000, 28, seed=11)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "tpu_use_f64_hist": True, "verbosity": -1}
    launches = {}
    for mode in ("leafwise", "level"):
        texts = {}
        for dev in ("cuda", "cpu"):
            H.reset_launches()
            bst = lt.train({**params, "tpu_grow_mode": mode,
                            "device_type": dev},
                           lt.Dataset(X, label=y), num_boost_round=3,
                           verbose_eval=False)
            if bst._gbdt.train_path != mode:
                raise AssertionError(f"f64 {mode} run took "
                                     f"{bst._gbdt.train_path}")
            if dev == "cuda":
                launches[mode] = H.LAUNCHES["f64"] if mode == "leafwise" \
                    else H.WORDS_LAUNCHES["f64"]
            t = bst.model_to_string()
            texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
        if texts["cuda"] != texts["cpu"]:
            raise AssertionError(f"f64 {mode} trees differ between cuda "
                                 "and cpu")
        if launches[mode] == 0:
            raise AssertionError(f"the f64 {mode} run never launched its "
                                 "kernel")
    log(f"f64: cuda and cpu trees equal, leaf-wise and level (3 trees, 31 "
        f"leaves; B1 f64 launches {launches['leafwise']}, B5 f64 launches "
        f"{launches['level']})")
    return launches


# ---------------------------------------------------------------------------
# the level builder: kernel B5 and the level path
# ---------------------------------------------------------------------------
def level_run(torch, lt, ds, params, rounds, Xte, yte, what) -> tuple:
    """`train_run` under ``tpu_grow_mode=level``: the log must name the
    level path, B5's plain twin is counted (a call fails the run), and
    each level build is timed on its own (synchronized wall ms)."""
    from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils import log as port_log
    lines, plain, build_ms = [], [0], []
    real_plain = H.histogram_words_plain
    real_build = DeviceTreeLearner._level_train_fresh

    def counting(*args, **kw):
        plain[0] += 1
        return real_plain(*args, **kw)

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_build(self, *args, **kw)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    H.histogram_words_plain = counting
    DeviceTreeLearner._level_train_fresh = timed
    port_log.register_callback(lines.append)
    try:
        bst, r = train_run(torch, lt, ds, {**params, "verbosity": 1,
                                           "tpu_grow_mode": "level"},
                           rounds, Xte, yte, what)
    finally:
        port_log.register_callback(None)
        H.histogram_words_plain = real_plain
        DeviceTreeLearner._level_train_fresh = real_build
    g = bst._gbdt
    if plain[0]:
        raise AssertionError(f"{what}: B5's plain twin ran {plain[0]} times "
                             "on the card's path")
    if g.train_path != "level" or not any("training path: level" in ln
                                          for ln in lines):
        raise AssertionError(f"{what}: took {g.train_path}; log "
                             f"{lines[:3]}")
    if r["launches"]["B5"] == 0:
        raise AssertionError(f"{what}: B5 never launched")
    r["rounds_per_tree"] = [s[0] for s in g.level_stats]
    r["splits_executed_per_tree"] = [s[1] for s in g.level_stats]
    r["fallbacks"] = g.learner.level_fallbacks
    r["build_ms"] = build_ms
    r["median_build_ms"] = statistics.median(build_ms[1:] or build_ms)
    return bst, r


def phase_level_main(torch, lt, ds, params, X, y, rows: int, max_bin: int,
                     leaf: dict) -> dict:
    """The level path on phase 4's data and params (255 leaves): AUC
    within 2e-3 of the leaf-wise run; rounds, executed splits and
    fallbacks per tree; one profiled round at 63 bins."""
    rounds = ROUNDS[max_bin]
    bst, r = level_run(torch, lt, ds, params, rounds, X[rows:], y[rows:],
                       f"level {max_bin}")
    if abs(r["auc"] - leaf["auc"]) > 2e-3:
        raise AssertionError(f"level AUC {r['auc']} is not within 2e-3 of "
                             f"the leaf-wise {leaf['auc']}")
    r["auc_leafwise"] = leaf["auc"]
    log_level(r, f"main level max_bin={max_bin}", "leaf-wise", leaf["auc"])
    if max_bin == 63:
        r["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    return r


def log_level(r, what, other, other_auc) -> None:
    lp = r["launches_per_tree"]
    log(f"{what}: first round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms, median level build "
        f"{r['median_build_ms']:.1f} ms, rounds per tree "
        f"{r['rounds_per_tree']}, executed splits per tree "
        f"{r['splits_executed_per_tree']}, fallbacks {r['fallbacks']}, "
        f"launches per tree B5 {lp['B5']:.1f} B1 {lp['B1']:.1f}, holdout "
        f"AUC {r['auc']:.6f} ({other} {other_auc:.6f}), predict "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB")


def phase_level_depth(torch, lt, ds, params, X, y, rows: int) -> dict:
    """The level path where its speculation covers the tree: max_depth 8
    (255 leaves at most, within the 1,147-split budget), 63 bins, 5
    rounds. Every tree must be exact (no fallback), and the AUC within
    2e-3 of the aligned engine's on the same params (both grow the
    leaf-wise trees); one profiled round."""
    p = {**params, "max_depth": 8}
    bst, a = train_run(torch, lt, ds, p, 5, X[rows:], y[rows:],
                       "aligned max_depth 8")
    if bst._gbdt.train_path != "aligned":
        raise AssertionError(f"max_depth 8 under auto took "
                             f"{bst._gbdt.train_path}")
    del bst
    bst, r = level_run(torch, lt, ds, p, 5, X[rows:], y[rows:],
                       "level max_depth 8")
    if r["fallbacks"] or r["launches"]["B1"]:
        raise AssertionError(f"level max_depth 8 fell back "
                             f"{r['fallbacks']} times")
    if abs(r["auc"] - a["auc"]) > 2e-3:
        raise AssertionError(f"level max_depth 8 AUC {r['auc']} is not "
                             f"within 2e-3 of the aligned {a['auc']}")
    r["aligned"] = {k: a[k] for k in ("auc", "median_iter_ms",
                                      "first_round_s")}
    log_level(r, "level max_depth=8 max_bin=63", "aligned", a["auc"])
    log(f"aligned max_depth=8 max_bin=63: median iteration "
        f"{a['median_iter_ms']:.1f} ms, holdout AUC {a['auc']:.6f}")
    r["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    return r


def capture_words_calls(torch, lt, ds, params) -> dict:
    """One level tree with B5's calls recorded (clones of their inputs):
    the root's, and the round's with the most segments."""
    from lightgbm_tpu_torch.models import level_builder as LB
    real = LB.histogram_from_words
    keep = {}

    def record(*args, **kw):
        nseg = args[3].numel()
        if "root" not in keep:
            keep["root"] = (tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args), kw)
        elif nseg > keep.get("wide_segments", 0):
            keep.pop("wide", None)
            keep["wide"] = (tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args), kw)
            keep["wide_segments"] = nseg
        return real(*args, **kw)

    LB.histogram_from_words = record
    try:
        lt.train({**params, "tpu_grow_mode": "level"}, ds,
                 num_boost_round=1, verbose_eval=False)
    finally:
        LB.histogram_from_words = real
    return keep


def words_abs_sums(torch, g, h, beg, cnt):
    """[S, 2] sum of |g| and |h| over each segment's rows (the scale of
    B5's f32 tolerance); NaN and Inf add nothing."""
    cnt = cnt.long()
    seg = torch.repeat_interleave(torch.arange(cnt.numel(), device=g.device),
                                  cnt)
    pos = beg.long()[seg] + torch.arange(seg.numel(), device=g.device) \
        - (torch.cumsum(cnt, 0) - cnt)[seg]
    v = torch.stack([g[pos], h[pos]], 1)
    out = torch.zeros((cnt.numel(), 2), dtype=torch.float32, device=g.device)
    return out.index_add_(0, seg, torch.where(torch.isfinite(v), v.abs(),
                                              0.0))


def phase_level_parity(torch, lt, ds, params, max_bin: int) -> dict:
    """B5 against its plain twin on the inputs of one level tree, the root
    and the widest round (the most segments): "f32" counts equal and g/h
    within 1e-5 x each segment's sum of |g| (|h|), max |d| / sum printed,
    and "f64" bit-equal; both again on a payload with NaN, +Inf and -Inf
    in g and h, cell by cell against the twin. Each timed beside the
    twin, the byte bound and one ``index_add_`` over a prebuilt flat
    (segment, feature, bin) index."""
    from lightgbm_tpu_torch.ops import histogram as H
    calls = capture_words_calls(torch, lt, ds, params)
    res = {}
    for what in ("root", "wide"):
        args, kw = calls[what]
        words, g, h, beg, cnt, F, B = args
        kw = {k: v for k, v in kw.items() if k != "precision"}
        rows = int(cnt.sum())
        nseg = beg.numel()
        scale = words_abs_sums(torch, g, h, beg, cnt)
        ref = H.histogram_words_plain(*args)
        r = {"rows": rows, "segments": nseg, "library_ms": None}
        for prec in ("f32", "f64"):
            run = (lambda prec=prec: H.histogram_from_words(
                *args, **kw, precision=prec))
            got = run()
            tag = f"B5 {what}, {max_bin} bins, {nseg} segments, {prec}"
            if prec == "f64":
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    d = (got - ref).abs().max().item()
                    raise AssertionError(f"{tag}: differs from its twin: "
                                         f"max |d| {d}")
                log(f"  check {tag}: bit-equal to the twin")
            else:
                r["max_abs_err"] = check_hist(torch, got, ref, scale, tag)
                err = (got[..., :2] - ref[..., :2]).abs().double()
                r["max_rel_err"] = (err / scale[:, None, None, :].double()
                                    .clamp_min(1e-300)).max().item()
            r[f"ms_{prec}"] = cuda_ms(torch, run)
            del got
        r["ms"] = r["ms_f32"]
        r["plain_ms"] = cuda_ms(torch, lambda: H.histogram_words_plain(
            *args), reps=2)
        r["bound_ms"], r["bound_by"] = bound(
            rows * (words.shape[0] * 4 + 8) + nseg * 8
            + nseg * F * B * 3 * 4, 3 * F * rows)
        # the yardstick: one index_add_ over the rows' flat cells
        seg = torch.repeat_interleave(
            torch.arange(nseg, device=words.device), cnt.long())
        pos = beg.long()[seg] + torch.arange(rows, device=words.device) \
            - (torch.cumsum(cnt.long(), 0) - cnt.long())[seg]
        # NaN, +Inf and -Inf in g and h of about one segment row in 997
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        pick = pos[torch.randperm(rows, generator=gen, device=DEVICE)[
            :max(3, rows // 997)]]
        f = torch.arange(F, device=words.device)
        cell = (((words[f >> 2][:, pos] >> ((f & 3) * 8)[:, None]) & 255)
                .long() + (f * B)[:, None] + (seg * F * B)[None, :]) \
            .t().reshape(-1)
        pay = torch.stack([g[pos], h[pos], torch.ones_like(g[pos])], dim=1)
        pay = pay[:, None, :].expand(-1, F, -1).reshape(-1, 3)
        out = torch.zeros((nseg * F * B, 3), dtype=torch.float32,
                          device=words.device)
        r["library_ms"] = cuda_ms(
            torch, lambda: out.index_add_(0, cell, pay), reps=2)
        del seg, pos, cell, pay, out
        bad_g, bad_h = g.clone(), h.clone()
        vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                            device=DEVICE)
        i = torch.arange(pick.numel(), device=DEVICE)
        bad_g[pick[i % 2 == 0]] = vals[(i % 3)[i % 2 == 0]]
        bad_h[pick[i % 2 == 1]] = vals[(i % 3)[i % 2 == 1]]
        bad = (words, bad_g, bad_h, beg, cnt, F, B)
        bad_ref = H.histogram_words_plain(*bad)
        bad_scale = words_abs_sums(torch, bad_g, bad_h, beg, cnt)
        r["nonfinite"] = {prec: check_hist_nonfinite(
            torch, H.histogram_from_words(*bad, **kw, precision=prec),
            bad_ref, bad_scale,
            f"B5 NaN/Inf {what}, {max_bin} bins, {prec}")
            for prec in ("f32", "f64")}
        del bad, bad_g, bad_h, bad_ref
        log(f"kernel histogram_words ({what}, {max_bin} bins, {rows} rows in "
            f"{nseg} segments): f32 {r['ms_f32']:.4f} ms (max |d| / "
            f"segment sum|.| {r['max_rel_err']:.3e}), f64 "
            f"{r['ms_f64']:.4f} ms (bit-equal), plain "
            f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, data-sheet "
            "3.35 TB/s)")
        res[what] = r
        del ref
    del calls
    torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------------------
# ranking: MSLR shape
# ---------------------------------------------------------------------------
def synth_mslr(n: int, f: int, seed: int = 11):
    """MSLR-shaped ranking data: queries of 80-159 documents, graded 0-4
    relevance by within-query quantile of a sparse linear signal (a copy
    of the recipe of bench.py::synth_mslr)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    w = np.zeros(f, np.float32)
    k = min(25, f)
    idx = rng.choice(f, k, replace=False)
    w[idx] = rng.standard_normal(k).astype(np.float32)
    s = X @ w / 5.0 + 0.8 * rng.standard_normal(n).astype(np.float32)
    sizes = []
    left = n
    while left > 0:
        q = min(int(rng.integers(80, 160)), left)
        sizes.append(q)
        left -= q
    group = np.asarray(sizes, np.int32)
    y = np.zeros(n, np.float32)
    pos = 0
    for q in sizes:
        ranks = s[pos:pos + q].argsort().argsort() / max(q - 1, 1)
        y[pos:pos + q] = np.digitize(ranks, [0.55, 0.75, 0.9, 0.97])
        pos += q
    return X, y, group


# ---------------------------------------------------------------------------
# categorical splits: the airline-delay shape
# ---------------------------------------------------------------------------
# the airline table of szilard/benchm-ml (the data of LightGBM's
# categorical experiment): Month, DayofMonth, DayOfWeek, UniqueCarrier,
# Origin, Dest (categorical), DepTime, Distance (numerical)
AIRLINE_CODES = (12, 31, 7, 22, 300, 300)
AIRLINE_CATS = list(range(len(AIRLINE_CODES)))
# the leaf-wise run cut from 5 to make room for phase 19
AIRLINE_ROUNDS = {"auto": 10, "leafwise": 3, "level": 10, "big_n": 3}
AIRLINE_ZIPF = 1.3           # Origin and Dest: a few hub airports


def synth_airline(n: int, seed: int = 13, zipf: float = AIRLINE_ZIPF):
    """Airline-delay-shaped rows (float32 [n, 8]) and the
    ``dep_delayed_15min`` label: Month 1-12, DayofMonth 1-31, DayOfWeek
    1-7, UniqueCarrier 0-21 uniform; Origin and Dest Zipf-skewed (s
    ``zipf``: the published table's ~1.1, whose 273 bins need uint16;
    phase 15 keeps 1.3, within uint8, for the aligned engine) over 300
    airports whose ranks are shuffled against their codes;
    DepTime as hhmm (0-2359, most departures by day) and Distance 30-5000
    miles (log-normal). The label (about 19% positive) is drawn from a
    logistic model with a random effect per category of each categorical
    column, random in the code (no threshold on a code stands in for a
    set of categories), a rising DepTime term and noise."""
    rng = np.random.default_rng(seed)
    # the model (effects, airport ranks) from a generator of its own, so
    # that it does not change with n
    model = np.random.default_rng(seed + 1)
    X = np.empty((n, 8), np.float32)
    logit = np.full(n, -1.85, np.float32)
    for j, codes in enumerate(AIRLINE_CODES):
        effect = model.normal(0.0, 0.35, codes).astype(np.float32)
        if codes == 300:
            p = 1.0 / np.arange(1, codes + 1) ** zipf
            c = np.searchsorted(np.cumsum(p / p.sum()), rng.random(n))
            code = model.permutation(codes)[np.minimum(c, codes - 1)]
        else:
            code = rng.integers(0, codes, n)
        X[:, j] = code + (1 if j < 3 else 0)       # Month, days from 1
        logit += effect[code]
    hour = np.clip(rng.normal(13.5, 4.5, n), 0, 23.99)
    X[:, 6] = np.floor(hour) * 100 + np.floor((hour % 1) * 60)
    X[:, 7] = np.clip(np.exp(rng.normal(6.4, 0.7, n)), 30, 5000).round()
    logit += 0.08 * (hour - 13.5) + 0.2 * rng.standard_normal(n)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int8)
    return X, y


TWINS = (("aligned", "move_pass_plain"), ("aligned", "count_pass_plain"),
         ("aligned", "slot_hist_pass_plain"), ("histogram", "histogram_plain"),
         ("histogram", "histogram_words_plain"))


def airline_run(torch, lt, ds, params, rounds, Xte, yte, what) -> tuple:
    """`train_run` with the plain twins of B1-B5 counted (a call on the
    card's path fails the run) and the port's log kept: the path taken
    and logged, categorical nodes per tree (a run without one fails),
    rounds, executed splits and fallbacks per tree."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils import log as port_log
    mods = {"aligned": A, "histogram": H}
    plain = {key: 0 for key in TWINS}
    real = {key: getattr(mods[key[0]], key[1]) for key in TWINS}

    def counting(key):
        def fn(*args, **kw):
            plain[key] += 1
            return real[key](*args, **kw)
        return fn

    lines = []
    for key in TWINS:
        setattr(mods[key[0]], key[1], counting(key))
    port_log.register_callback(lines.append)
    try:
        bst, r = train_run(torch, lt, ds, {**params, "verbosity": 1},
                           rounds, Xte, yte, what)
    finally:
        port_log.register_callback(None)
        for key in TWINS:
            setattr(mods[key[0]], key[1], real[key])
    if any(plain.values()):
        raise AssertionError(f"{what}: plain twins ran on the card's path: "
                             f"{ {k[1]: v for k, v in plain.items()} }")
    g = bst._gbdt
    r["train_path"] = g.train_path
    if not any(f"training path: {g.train_path}" in ln for ln in lines):
        raise AssertionError(f"{what}: the log does not name the "
                             f"{g.train_path} path: {lines[:3]}")
    r["cat_nodes_per_tree"] = [int(t.num_cat) for t in bst.trees]
    r["path_log"] = [ln for ln in lines if "training path" in ln]
    stats = g.aligned_stats if g.train_path == "aligned" \
        else g.level_stats if g.train_path == "level" else []
    r["rounds_per_tree"] = [st[0] for st in stats]
    r["splits_executed_per_tree"] = [st[1] for st in stats]
    r["fallbacks"] = (g._aligned_eng.fallbacks if g.train_path == "aligned"
                      else g.learner.level_fallbacks)
    log(f"airline {what}: path {g.train_path}, first round "
        f"{r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms, categorical nodes per tree "
        f"{r['cat_nodes_per_tree']}, rounds per tree "
        f"{r['rounds_per_tree']}, executed splits per tree "
        f"{r['splits_executed_per_tree']}, fallbacks {r['fallbacks']}, "
        f"launches {r['launches']}, holdout AUC {r['auc']:.6f}, predict "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB")
    return bst, r


def phase_airline(torch, lt, rows: int, holdout: int) -> dict:
    """Categorical splits at the airline shape (`synth_airline`, 255
    leaves, max_bin 255, the default categorical parameters): (a)
    ``auto``, which must take the aligned engine, against the same run
    with the six columns passed as numerical; (b) leaf-wise; (c) level at
    ``max_depth`` 8, against ``auto`` at ``max_depth`` 8; (d)
    ``tpu_force_big_n`` (the count pass); (e) B2's
    and B3's categorical route against their twins on one tree's calls
    (`phase_airline_parity`)."""
    from lightgbm_tpu_torch.ops import aligned as A
    t_phase = t0 = time.perf_counter()
    X, y = synth_airline(rows + holdout)
    Xtr, ytr, Xte, yte = X[:rows], y[:rows], X[rows:], y[rows:]
    log(f"data: {rows}+{holdout} x 8 synthetic airline rows in "
        f"{time.perf_counter() - t0:.3f} s, {y.mean():.4f} positive")
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1}
    res = {"positive_rate": float(y.mean())}
    dss = {}
    for kind, cats in (("categorical", AIRLINE_CATS), ("numerical", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dss[kind] = lt.Dataset(Xtr, label=ytr, params=params,
                               categorical_feature=cats,
                               free_raw_data=False).construct()
        torch.cuda.synchronize()
        res[f"binning_s_{kind}"] = time.perf_counter() - t0
    ds = dss["categorical"]
    bins = [m.num_bin for m in ds._handle.used_mappers()]
    res["num_bin"] = bins
    log(f"airline binning: {res['binning_s_categorical']:.3f} s with six "
        f"categorical columns, {res['binning_s_numerical']:.3f} s all "
        f"numerical; bins per column {bins}")
    # (a) auto, and the same run on the numerical columns
    n_auto = AIRLINE_ROUNDS["auto"]
    bst, a = airline_run(torch, lt, ds, params, n_auto, Xte, yte, "auto")
    if a["train_path"] != "aligned":
        raise AssertionError(f"airline auto took {a['train_path']}")
    if not any(a["cat_nodes_per_tree"]):
        raise AssertionError("airline auto grew no categorical node")
    if a["launches"]["move_pass_cat"] == 0:
        raise AssertionError("airline auto never routed by a bitset in B2")
    n_leaf = AIRLINE_ROUNDS["leafwise"]
    a[f"auc_at_{n_leaf}"] = holdout_auc(lt, bst.predict(
        Xte, raw_score=True, num_iteration=n_leaf), yte)
    a["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    bst, num = airline_run(torch, lt, dss["numerical"], params, n_auto, Xte,
                           yte, "auto, categories as numbers")
    del bst, dss
    torch.cuda.empty_cache()
    log(f"airline holdout AUC after {n_auto} rounds: categorical "
        f"{a['auc']:.6f}, the same columns as numbers {num['auc']:.6f}")
    if not a["auc"] > num["auc"]:
        raise AssertionError(f"airline categorical AUC {a['auc']} is not "
                             f"above the numerical run's {num['auc']}")
    res["auto"] = a
    res["auto_numerical"] = {k: num[k] for k in (
        "auc", "median_iter_ms", "first_round_s", "launches")}
    # (b) leaf-wise
    bst, lw = airline_run(torch, lt, ds, {**params,
                                          "tpu_grow_mode": "leafwise"},
                          n_leaf, Xte, yte, "leafwise")
    del bst
    if abs(lw["auc"] - a[f"auc_at_{n_leaf}"]) > 2e-3:
        raise AssertionError(f"airline leaf-wise AUC {lw['auc']} is not "
                             f"within 2e-3 of auto's at {n_leaf} rounds "
                             f"{a[f'auc_at_{n_leaf}']}")
    res["leafwise"] = lw
    # (c) level at max_depth 8, against auto on the same params (both
    # grow the leaf-wise trees; capped at depth 8 they are not (a)'s)
    n_level = AIRLINE_ROUNDS["level"]
    depth8 = {**params, "max_depth": 8}
    bst, a8 = airline_run(torch, lt, ds, depth8, n_level, Xte, yte,
                          "auto depth 8")
    del bst
    bst, lv = airline_run(torch, lt, ds, {**depth8, "tpu_grow_mode": "level"},
                          n_level, Xte, yte, "level depth 8")
    del bst
    if lv["train_path"] != "level" or lv["fallbacks"] \
            or lv["launches"]["B1"]:
        raise AssertionError(f"airline level max_depth 8 fell back "
                             f"{lv['fallbacks']} times")
    lv["auc_auto_depth8"] = a8["auc"]
    lv["auto_depth8_median_iter_ms"] = a8["median_iter_ms"]
    log(f"airline holdout AUC after {n_level} rounds: level depth 8 "
        f"{lv['auc']:.6f}, auto depth 8 {a8['auc']:.6f}, auto "
        f"{a['auc']:.6f}")
    if abs(lv["auc"] - a8["auc"]) > 2e-3:
        raise AssertionError(f"airline level AUC {lv['auc']} is not within "
                             f"2e-3 of auto's at max_depth 8 {a8['auc']}")
    res["level"] = lv
    # (d) big-n: the count pass on every round
    bst, bn = airline_run(torch, lt, ds, {**params, "tpu_force_big_n": True},
                          AIRLINE_ROUNDS["big_n"], Xte, yte, "big-n")
    if bst._gbdt._aligned_eng.compact or bn["launches"]["count_pass_cat"] \
            == 0:
        raise AssertionError("airline big-n left the STANDARD layout or "
                             "never counted by a bitset")
    bn["profile"] = profile_round(torch, bst)
    if bn["profile"]["count_calls"] == 0:
        raise AssertionError("the airline big-n profiled round made no "
                             "count pass")
    del bst
    torch.cuda.empty_cache()
    res["big_n"] = bn
    # (e) the kernels against their twins on one tree's calls
    res["kernels"] = phase_airline_parity(torch, lt, ds, params, A)
    del ds
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"airline phase: {res['phase_s']:.1f} s")
    return res


def phase_airline_parity(torch, lt, ds, params, A) -> dict:
    """B2's and B3's categorical route on the calls of one airline tree:
    the root's move and the widest round's (COMPACT), and the widest
    round's move and count pass of a big-n tree (STANDARD), through the
    kernels and their twins on the card: counts equal, moved records
    equal, the children's histograms by `check_hist`; then B2's partition
    alone and B3's launch alone (warm and cold L2) timed beside the twin
    and the byte bound, one call's nodes from a captured CUDA graph."""
    from lightgbm_tpu_torch.utils.launches import graph_launches
    res = {}
    calls = capture_kernel_calls(torch, lt, ds, params)
    err = 0.0
    for key in ("move_root", "move_wide"):
        if calls[f"{key}_cbits"] is None:
            raise AssertionError(f"airline {key} came without a bitset table")
        err = max(err, check_move(torch, A, calls[key], f"airline {key}",
                                  cbits=calls[f"{key}_cbits"]))
    args, cbits = calls["move_wide"], calls["move_wide_cbits"]
    rec, r1, meta, k, bits, w_used = (args[0], args[1], args[5], args[8],
                                      args[12], args[13])
    nc, W, C = rec.shape
    cnt = meta & 0xFFFFF
    is_copy = ((r1 >> 16) & 1) == 1
    is_cat = (((r1 >> A.R_CAT) & 1) == 1) & ~is_copy & (cnt > 0)
    if not bool(is_cat.any()):
        raise AssertionError("the widest airline round has no categorical "
                             "chunk")
    split_rows = int(cnt[~is_copy].sum())
    copy_chunks = int((is_copy & (cnt > 0)).sum())
    buf = torch.empty_like(rec)
    part = (*args[:8], k, bits, w_used, buf, cbits.data_ptr())
    no_hist = (*args[:8], 0, *args[9:])
    moved = 2 * (split_rows * w_used * 4 + copy_chunks * w_used * C * 4)
    r = {"max_abs_err": 0.0, "moves_max_abs_err": err,
         "split_blocks": calls["wide_blocks"], "split_rows": split_rows,
         "cat_rows": int(cnt[is_cat].sum()), "copy_chunks": copy_chunks,
         "ms": cuda_ms(torch, lambda: A._move_partition_cuda(*part),
                       reps=20),
         "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
             *no_hist, out=buf, cbits=cbits), reps=2),
         "library_ms": None,
         "graph": graph_launches(lambda: A._move_partition_cuda(*part))}
    if r["graph"] != {"kernels": 1, "memsets": 1, "other": 0}:
        raise AssertionError(f"B2's categorical partition enqueued "
                             f"{r['graph']}, not one memset and one kernel")
    r["launches_per_call"] = r["graph"]["kernels"] + r["graph"]["memsets"]
    r["bound_ms"], r["bound_by"] = bound(
        moved + nc * 9 * 4 + (k + 1) * 8 * 4, 0)
    res["partition_cat"] = r
    del buf, part, calls
    torch.cuda.empty_cache()
    # STANDARD: the count pass of a big-n tree's widest round
    calls = capture_kernel_calls(torch, lt, ds,
                                 {**params, "tpu_force_big_n": True})
    err = check_move(torch, A, calls["move_wide"],
                     "airline move_wide, STANDARD",
                     cbits=calls["move_wide_cbits"])
    args, cbits = calls["count_wide"], calls["count_wide_cbits"]
    if args is None or cbits is None:
        raise AssertionError("the airline big-n tree made no categorical "
                             "count pass")
    got = A.count_pass(*args, cbits=cbits)
    if not torch.equal(got, A.count_pass_plain(*args, cbits=cbits)):
        raise AssertionError("count_pass differs from its twin on the "
                             "airline round")
    meta, ks, k = args[3], args[5], args[6]
    nc = args[0].shape[0]
    rows = int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
    is_cat = ((args[1] >> A.R_CAT) & 1) == 1
    alone = torch.empty(k, dtype=torch.int32, device=DEVICE)
    cptr = cbits.data_ptr()
    r = {"max_abs_err": 0.0, "moves_max_abs_err": err, "rows": rows,
         "cat_rows": int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)
                                          & is_cat].sum()),
         "chunks": nc,
         "ms": cuda_ms(torch, lambda: A._count_cuda(*args, alone, cptr),
                       reps=20),
         "cold_ms": cold_ms(torch, lambda: A._count_cuda(*args, alone,
                                                          cptr)),
         "wrapper_ms": cuda_ms(torch, lambda: A.count_pass(
             *args, cbits=cbits), reps=20),
         "plain_ms": cuda_ms(torch, lambda: A.count_pass_plain(
             *args, cbits=cbits), reps=2),
         "library_ms": None,
         "graph": graph_launches(lambda: A.count_pass(*args, cbits=cbits))}
    if r["graph"] != {"kernels": 1, "memsets": 0, "other": 0}:
        raise AssertionError(f"B3's categorical count enqueued "
                             f"{r['graph']}, not one kernel")
    r["launches_per_call"] = r["graph"]["kernels"]
    r["bound_ms"], r["bound_by"] = bound(
        rows * 4 + nc * 5 * 4 + k * 4 + (k + 1) * 8 * 4, rows)
    res["count_cat"] = r
    shown = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    for name, r in res.items():
        log(f"kernel {name} (airline): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{ {k: v for k, v in r.items() if k not in shown} }")
    del calls, args, alone
    torch.cuda.empty_cache()
    return res


# the one-hot airline table (phase 19): the six code columns of
# `synth_airline` one-hot, DepTime and Distance dense in front
EFB_ROUNDS = {"auto": 5, "big_n": 3, "leafwise": 3, "unbundled": 3}
EFB_CUT_ROWS = 20_000
# phase 19 (d), the Allstate law at 1M rows, runs when the smoke has
# taken less than this many seconds so far
EFB_ALLSTATE_ROWS = 1_000_000
EFB_ALLSTATE_BEFORE_S = 1000.0


def airline_onehot_csr(X):
    """The one-hot airline table of szilard/benchm-ml's one-hot runs from
    `synth_airline` rows: DepTime and Distance (columns 0 and 1), then
    Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest one-hot
    (12 + 31 + 7 + 22 + 300 + 300 columns); a scipy CSR of 8 entries a
    row (a DepTime of 0 stored as an explicit zero)."""
    import scipy.sparse as sp
    n = len(X)
    offs = 2 + np.concatenate([[0], np.cumsum(AIRLINE_CODES)[:-1]])
    cols = np.empty((n, 8), np.int32)
    cols[:, 0], cols[:, 1] = 0, 1
    for j in range(len(AIRLINE_CODES)):
        cols[:, 2 + j] = offs[j] + X[:, j].astype(np.int32) \
            - (1 if j < 3 else 0)
    data = np.ones((n, 8), np.float32)
    data[:, 0], data[:, 1] = X[:, 6], X[:, 7]
    return sp.csr_matrix((data.reshape(-1), cols.reshape(-1),
                          np.arange(0, 8 * n + 1, 8, dtype=np.int64)),
                         shape=(n, 2 + sum(AIRLINE_CODES)))


def efb_dataset(torch, lt, X, y, params, what) -> tuple:
    """A constructed Dataset of a CSR matrix, the sparse ingest timed
    apart from the bundling plan (`plan_bundles`) and its application on
    the device (`apply_bundles`); G, F and the bins' bytes bundled and
    not."""
    from lightgbm_tpu_torch.io import dataset as D
    spent = {"plan_s": 0.0, "apply_s": 0.0}
    real = {"plan": D.plan_bundles, "apply": D.apply_bundles}

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[f"{key}_s"] += time.perf_counter() - t0
            return out
        return run

    D.plan_bundles = timed("plan", real["plan"])
    D.apply_bundles = timed("apply", real["apply"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = lt.Dataset(X, label=y, params=params,
                        free_raw_data=False).construct()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        D.plan_bundles, D.apply_bundles = real["plan"], real["apply"]
    h = ds._handle
    r = {"construct_s": total, **spent,
         "ingest_s": total - spent["plan_s"] - spent["apply_s"],
         "features": h.num_features, "storage_cols": h.num_storage_cols,
         "bins_bytes": h.num_data * h.num_storage_cols,
         "unbundled_bytes": h.num_data * h.num_features,
         "bundled": h.bundles is not None}
    if h.bundles is not None:
        r["group_num_bin"] = [int(v) for v in h.bundles.group_num_bin]
    log(f"{what}: {X.shape[0]} x {X.shape[1]} CSR ({X.nnz / X.shape[0]:.2f} "
        f"nonzeros a row) -> {r['features']} features in "
        f"{r['storage_cols']} storage columns, {r['bins_bytes']} bytes of "
        f"bins ({r['unbundled_bytes']} unbundled); construct "
        f"{total:.3f} s: sparse ingest {r['ingest_s']:.3f} s, plan "
        f"{spent['plan_s']:.3f} s, apply {spent['apply_s']:.3f} s")
    return ds, r


def same_trees(ta, tb, what) -> None:
    """The trees of two runs split on the same features at the same bins,
    their leaf values within rtol 1e-4, atol 1e-5 (C.7's bound)."""
    if len(ta) != len(tb):
        raise AssertionError(f"{what}: {len(ta)} trees against {len(tb)}")
    for i, (a, b) in enumerate(zip(ta, tb)):
        k = b.num_leaves - 1
        if a.num_leaves != b.num_leaves \
                or list(a.split_feature[:k]) != list(b.split_feature[:k]) \
                or list(a.threshold_in_bin[:k]) \
                != list(b.threshold_in_bin[:k]):
            raise AssertionError(f"{what}: tree {i} splits differ")
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   np.asarray(b.leaf_value[:k + 1]),
                                   rtol=1e-4, atol=1e-5)


def phase_efb(torch, lt, rows: int, holdout: int, t_main: float) -> dict:
    """Phase 19: sparse input and exclusive feature bundling on the
    one-hot airline table (`airline_onehot_csr` of `synth_airline`,
    255 leaves, max_bin 255): (a) ``auto`` (the aligned engine on the
    bundled records), ``tpu_force_big_n``, leaf-wise and
    ``enable_bundle=false``; (b) B2's and B3's bundled branch against
    their twins (`phase_efb_parity`); (c) the card against the CPU on a
    20,000-row cut; (d) the Allstate law leaf-wise at 1M rows when the
    time allows."""
    from lightgbm_tpu_torch.ops import aligned as A
    t_phase = t0 = time.perf_counter()
    X, y = synth_airline(rows + holdout)
    Xs = airline_onehot_csr(X)
    del X
    Xtr, ytr, Xte, yte = Xs[:rows], y[:rows], Xs[rows:], y[rows:]
    log(f"data: {rows}+{holdout} one-hot airline rows, {Xs.shape[1]} "
        f"columns, {Xs.nnz / Xs.shape[0]:.2f} nonzeros a row, in "
        f"{time.perf_counter() - t0:.3f} s")
    del Xs
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1}
    res = {}
    ds, res["dataset"] = efb_dataset(torch, lt, Xtr, ytr, params,
                                     "phase 19 (a) bundled")
    if not res["dataset"]["bundled"]:
        raise AssertionError("the one-hot airline table did not bundle")
    # (a) auto: the aligned engine on the bundled records
    bst, a = airline_run(torch, lt, ds, params, EFB_ROUNDS["auto"], Xte,
                         yte, "one-hot auto")
    g = bst._gbdt
    if a["train_path"] != "aligned" or not g.learner.bundled \
            or a["fallbacks"]:
        raise AssertionError(f"one-hot auto took {a['train_path']} with "
                             f"{a['fallbacks']} fallbacks")
    lc = a["launches"]
    if not lc["move_pass_bundled"] == lc["move_pass"] > 0:
        raise AssertionError(f"one-hot auto: {lc['move_pass_bundled']} "
                             f"bundled of {lc['move_pass']} B2 launches")
    n3 = EFB_ROUNDS["unbundled"]
    a[f"auc_at_{n3}"] = holdout_auc(lt, bst.predict(
        Xte, raw_score=True, num_iteration=n3), yte)
    a["profile"] = profile_round(torch, bst)
    del bst, g
    torch.cuda.empty_cache()
    res["auto"] = a
    # big-n: B3's bundled branch every round
    bst, bn = airline_run(torch, lt, ds, {**params, "tpu_force_big_n": True},
                          EFB_ROUNDS["big_n"], Xte, yte, "one-hot big-n")
    lc = bn["launches"]
    if bst._gbdt._aligned_eng.compact or bn["fallbacks"] \
            or not lc["count_pass_bundled"] == lc["count_pass"] > 0:
        raise AssertionError(f"one-hot big-n: {lc['count_pass_bundled']} "
                             f"bundled of {lc['count_pass']} B3 launches, "
                             f"{bn['fallbacks']} fallbacks")
    del bst
    torch.cuda.empty_cache()
    res["big_n"] = bn
    # leaf-wise: B1 over the storage columns, the split feature unpacked
    bst, lw = airline_run(torch, lt, ds, {**params,
                                          "tpu_grow_mode": "leafwise"},
                          EFB_ROUNDS["leafwise"], Xte, yte,
                          "one-hot leafwise")
    if lw["train_path"] != "leafwise" or not lw["launches"]["B1"]:
        raise AssertionError("one-hot leaf-wise did not run B1")
    del bst
    torch.cuda.empty_cache()
    res["leafwise"] = lw
    # (b) the kernels against their twins on the bundled records
    res["kernels"] = phase_efb_parity(torch, lt, ds, params, A)
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    # enable_bundle=false on the same CSR: 674 feature columns
    unb = {**params, "enable_bundle": False}
    ds, res["dataset_unbundled"] = efb_dataset(torch, lt, Xtr, ytr, unb,
                                               "phase 19 (a) unbundled")
    bst, ub = airline_run(torch, lt, ds, unb, n3, Xte, yte,
                          "one-hot unbundled")
    del bst, ds
    gc.collect()
    torch.cuda.empty_cache()
    res["unbundled"] = ub
    log(f"phase 19 (a): holdout AUC at {n3} rounds bundled "
        f"{a[f'auc_at_{n3}']:.6f}, unbundled {ub['auc']:.6f}; median "
        f"iteration auto {a['median_iter_ms']:.1f} ms, big-n "
        f"{bn['median_iter_ms']:.1f} ms, leaf-wise "
        f"{lw['median_iter_ms']:.1f} ms, unbundled "
        f"{ub['median_iter_ms']:.1f} ms ({ub['train_path']})")
    if abs(a[f"auc_at_{n3}"] - ub["auc"]) > 2e-3:
        raise AssertionError(f"bundled AUC {a[f'auc_at_{n3}']} is not "
                             f"within 2e-3 of unbundled {ub['auc']}")
    # (c) the card against the CPU on a 20,000-row cut
    res["cut"] = phase_efb_cut(torch, lt, Xtr[:EFB_CUT_ROWS],
                               ytr[:EFB_CUT_ROWS], Xte[:EFB_CUT_ROWS])
    del Xtr, Xte
    gc.collect()
    # (d) leaf-wise past 1020 features
    if time.perf_counter() - t_main < EFB_ALLSTATE_BEFORE_S:
        res["allstate"] = phase_efb_allstate(torch, lt)
    else:
        log(f"phase 19 (d): skipped, the smoke is past "
            f"{EFB_ALLSTATE_BEFORE_S:.0f} s")
        res["allstate"] = None
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {res['phase_s']:.1f} s")
    return res


def phase_efb_parity(torch, lt, ds, params, A) -> dict:
    """Phase 19 (b): B2's and B3's bundled branch on the calls of one
    tree on the one-hot airline records, the root's and the widest
    round's moves (COMPACT) and the widest round's count pass of a big-n
    tree (STANDARD), through the kernels and their twins: the partitions
    and counts bit-equal (integers), the children's histograms by
    `check_hist`. B2's partition alone and B3's launch alone timed, warm
    and cold (L2), beside the unbundled instantiation on the same
    records (what the unpack costs), the twin and the byte bound; one
    call's nodes from a captured CUDA graph."""
    from lightgbm_tpu_torch.utils.launches import graph_launches
    res = {}
    calls = capture_kernel_calls(torch, lt, ds, params)
    err = max(check_move(torch, A, calls[key], f"one-hot {key}",
                         bundled=True) for key in ("move_root", "move_wide"))
    args = calls["move_wide"]
    rec, r1, r2, meta, k, bits, w_used = (args[0], args[1], args[2],
                                          args[5], args[8], args[12],
                                          args[13])
    nc, W, C = rec.shape
    cnt = meta & 0xFFFFF
    is_copy = ((r1 >> 16) & 1) == 1
    packed = (((r2 >> 24) & 1) == 1) & ~is_copy & (cnt > 0)
    if not bool(packed.any()):
        raise AssertionError("the widest one-hot round splits no bundled "
                             "feature")
    split_rows = int(cnt[~is_copy].sum())
    copy_chunks = int((is_copy & (cnt > 0)).sum())
    buf = torch.empty_like(rec)
    part = (*args[:8], k, bits, w_used, buf, 0, True)
    flat = (*args[:8], k, bits, w_used, buf, 0, False)
    no_hist = (*args[:8], 0, *args[9:])
    moved = 2 * (split_rows * w_used * 4 + copy_chunks * w_used * C * 4)
    r = {"max_abs_err": 0.0, "moves_max_abs_err": err,
         "split_blocks": calls["wide_blocks"], "split_rows": split_rows,
         "packed_rows": int(cnt[packed].sum()), "copy_chunks": copy_chunks,
         "ms": cuda_ms(torch, lambda: A._move_partition_cuda(*part),
                       reps=20),
         "cold_ms": cold_ms(torch, lambda: A._move_partition_cuda(*part)),
         "unbundled_ms": cuda_ms(torch,
                                 lambda: A._move_partition_cuda(*flat),
                                 reps=20),
         "unbundled_cold_ms": cold_ms(
             torch, lambda: A._move_partition_cuda(*flat)),
         "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
             *no_hist, out=buf, bundled=True), reps=2),
         "library_ms": None,
         "graph": graph_launches(lambda: A._move_partition_cuda(*part))}
    if r["graph"] != {"kernels": 1, "memsets": 1, "other": 0}:
        raise AssertionError(f"B2's bundled partition enqueued "
                             f"{r['graph']}, not one memset and one kernel")
    r["launches_per_call"] = r["graph"]["kernels"] + r["graph"]["memsets"]
    r["bound_ms"], r["bound_by"] = bound(moved + nc * 9 * 4, 0)
    res["partition_bundled"] = r
    del buf, part, flat, calls
    torch.cuda.empty_cache()
    calls = capture_kernel_calls(torch, lt, ds,
                                 {**params, "tpu_force_big_n": True})
    err = check_move(torch, A, calls["move_wide"],
                     "one-hot move_wide, STANDARD", bundled=True)
    args = calls["count_wide"]
    if args is None:
        raise AssertionError("the one-hot big-n tree made no count pass")
    got = A.count_pass(*args, bundled=True)
    if not torch.equal(got, A.count_pass_plain(*args, bundled=True)):
        raise AssertionError("count_pass differs from its twin on the "
                             "one-hot round")
    meta, ks, k = args[3], args[5], args[6]
    nc = args[0].shape[0]
    rows = int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
    alone = torch.empty(k, dtype=torch.int32, device=DEVICE)
    r = {"max_abs_err": 0.0, "moves_max_abs_err": err, "rows": rows,
         "chunks": nc,
         "ms": cuda_ms(torch, lambda: A._count_cuda(*args, alone, 0, True),
                       reps=20),
         "cold_ms": cold_ms(torch, lambda: A._count_cuda(*args, alone, 0,
                                                          True)),
         "unbundled_ms": cuda_ms(torch, lambda: A._count_cuda(
             *args, alone, 0, False), reps=20),
         "unbundled_cold_ms": cold_ms(torch, lambda: A._count_cuda(
             *args, alone, 0, False)),
         "wrapper_ms": cuda_ms(torch, lambda: A.count_pass(
             *args, bundled=True), reps=20),
         "plain_ms": cuda_ms(torch, lambda: A.count_pass_plain(
             *args, bundled=True), reps=2),
         "library_ms": None,
         "graph": graph_launches(lambda: A.count_pass(*args, bundled=True))}
    if r["graph"] != {"kernels": 1, "memsets": 0, "other": 0}:
        raise AssertionError(f"B3's bundled count enqueued {r['graph']}, "
                             "not one kernel")
    r["launches_per_call"] = r["graph"]["kernels"]
    r["bound_ms"], r["bound_by"] = bound(rows * 4 + nc * 5 * 4 + k * 4,
                                         rows)
    res["count_bundled"] = r
    shown = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    for name, r in res.items():
        log(f"kernel {name} (one-hot airline): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{ {k: v for k, v in r.items() if k not in shown} }")
    del calls, args, alone
    torch.cuda.empty_cache()
    return res


def phase_efb_cut(torch, lt, Xc, yc, Xp) -> dict:
    """Phase 19 (c): a 20,000-row cut of the one-hot airline CSR on the
    card and on the CPU: the f64 leaf-wise tree sections equal and the
    two boosters' CSR predictions (of ``Xp``) equal; the aligned engine's
    bundled trees (the kernels on the card, the twins on the CPU) within
    C.7's bound, no fallback."""
    t0 = time.perf_counter()
    # 15 leaves and 63 bins (the bundles keep theirs): the CPU runs take
    # the host's cores
    base = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}
    runs = {}
    for mode, extra in (("f64", {"tpu_use_f64_hist": True,
                                 "tpu_grow_mode": "leafwise"}),
                        ("aligned", {"tpu_grow_mode": "aligned"})):
        for dev in ("cuda", "cpu"):
            p = {**base, **extra, "device_type": dev}
            if dev == "cpu" and mode == "aligned":
                p["tpu_aligned_interpret"] = True
            bst = lt.train(p, lt.Dataset(Xc, label=yc), num_boost_round=3,
                           verbose_eval=False)
            g = bst._gbdt
            if not g.learner.bundled:
                raise AssertionError(f"phase 19 (c) {mode} {dev}: not "
                                     "bundled")
            if mode == "aligned" and (g.train_path != "aligned"
                                      or g._aligned_eng.fallbacks):
                raise AssertionError(f"phase 19 (c) aligned {dev}: path "
                                     f"{g.train_path}")
            runs[(mode, dev)] = bst
    text = [runs[("f64", d)].model_to_string() for d in ("cuda", "cpu")]
    sect = [t[t.index("Tree=0"):t.index("end of trees")] for t in text]
    if sect[0] != sect[1]:
        raise AssertionError("phase 19 (c): the f64 leaf-wise tree "
                             "sections differ between the card and the CPU")
    pc, pp = (runs[("f64", d)].predict(Xp, raw_score=True)
              for d in ("cuda", "cpu"))
    if not np.array_equal(pc, pp):
        raise AssertionError("phase 19 (c): CSR predictions differ, max "
                             f"{np.abs(pc - pp).max()}")
    same_trees(runs[("aligned", "cpu")].trees, runs[("aligned", "cuda")].trees,
               "phase 19 (c) aligned")
    r = {"rows": Xc.shape[0], "trees": len(runs[("f64", "cuda")].trees),
         "seconds": time.perf_counter() - t0}
    log(f"phase 19 (c): {r['rows']}-row cut, f64 leaf-wise tree sections "
        f"and CSR predictions equal on the card and the CPU, aligned "
        f"bundled trees within C.7's bound; {r['seconds']:.1f} s")
    return r


def allstate_csr(n: int, seed: int = 0):
    """The Allstate law of the JAX package's tests/test_efb.py (after
    LightGBM's Allstate benchmark, 13,184,290 x 4,228): 100 one-hot
    blocks of 20-60 columns, one column of each set in every row; the
    label is whether a row holds one of the first 40 columns."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 60, 100)
    cols = np.empty((n, len(sizes)), np.int32)
    off = 0
    for b, gs in enumerate(sizes):
        cols[:, b] = off + rng.integers(0, gs, n)
        off += int(gs)
    Xs = sp.csr_matrix((np.ones(cols.size, np.float32), cols.reshape(-1),
                        np.arange(0, cols.size + 1, len(sizes),
                                  dtype=np.int64)), shape=(n, off))
    y = (np.asarray(Xs[:, :40].sum(axis=1)).ravel() > 0).astype(np.float32)
    return Xs, y


def phase_efb_allstate(torch, lt) -> dict:
    """Phase 19 (d): the Allstate law at 1,000,000 rows under ``auto``:
    past 1,020 features the aligned gate refuses (and says so), and the
    trees grow leaf-wise on the bundled storage columns, 3 rounds, 255
    leaves; G <= 150 and finite predictions."""
    t0 = time.perf_counter()
    Xs, y = allstate_csr(EFB_ALLSTATE_ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds, d = efb_dataset(torch, lt, Xs, y, params, "phase 19 (d) Allstate law")
    t1 = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=3, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    g = bst._gbdt
    why = g.aligned_gate() or ""
    p = bst.predict(Xs[:20000])
    r = {**d, "train_s": train_s, "path": g.train_path, "gate": why,
         "finite": bool(np.isfinite(p).all()),
         "seconds": time.perf_counter() - t0}
    log(f"phase 19 (d): {d['features']} features in {d['storage_cols']} "
        f"storage columns, path {g.train_path} ({why}), 3 rounds in "
        f"{train_s:.3f} s, phase {r['seconds']:.1f} s")
    if not (d["storage_cols"] <= 150 and g.train_path == "leafwise"
            and why.startswith("num_features") and "> 1020" in why
            and r["finite"]):
        raise AssertionError(f"phase 19 (d) failed: {r}")
    del bst, ds, g
    gc.collect()
    torch.cuda.empty_cache()
    return r


def ndcg_at(preds, y, group, k=10) -> float:
    """Mean NDCG@k over the queries with a positive ideal DCG (a copy of
    bench.py::ndcg_at)."""
    pos = 0
    total, cnt = 0.0, 0
    for q in group:
        p = preds[pos:pos + q]
        lab = y[pos:pos + q]
        order = np.argsort(-p)[:k]
        dcg = np.sum((2.0 ** lab[order] - 1)
                     / np.log2(np.arange(len(order)) + 2))
        ideal = np.sort(lab)[::-1][:k]
        idcg = np.sum((2.0 ** ideal - 1) / np.log2(np.arange(len(ideal)) + 2))
        if idcg > 0:
            total += dcg / idcg
            cnt += 1
        pos += q
    return total / max(cnt, 1)


def ndcg_queries(group, rows: int):
    """The queries that lie wholly within the first ``rows`` rows (the
    protocol of bench.py::run_mslr)."""
    out, tot = [], 0
    for q in group:
        if tot + q > rows:
            break
        out.append(int(q))
        tot += q
    return out, tot


def rank_bound_ms(obj, label_np) -> tuple:
    """Least time of one lambdarank gradient on this card: bytes (score,
    label and gain read, g and h written, per document; offsets and inverse
    max DCG per query) against operations: each unordered pair with two
    different labels evaluated once at OPS_PER_PAIR, plus one compare per
    unordered pair for the ranks."""
    qb = obj.query_boundaries
    n, nq = int(qb[-1]), len(qb) - 1
    lab = label_np.astype(np.int64)
    distinct = 0
    allp = 0
    for lo, hi in zip(qb[:-1], qb[1:]):
        c = int(hi - lo)
        cnt = np.bincount(lab[lo:hi], minlength=5)
        distinct += (c * c - int((cnt * cnt).sum())) // 2
        allp += c * (c - 1) // 2
    nbytes = n * 5 * 4 + nq * 2 * 4
    return bound(nbytes, OPS_PER_PAIR * distinct + allp) + (distinct,)


def phase_rank_parity(torch, lt, y, group) -> dict:
    """B6 against its plain twin on the card, on four inputs: the MSLR
    queries with random scores, a set of long queries (1 to 5,000
    documents), and both under tpu_rank_sigmoid_bins=1024, where the
    objective on the card (fused semantics under ``auto``, the default
    tile 512) tables every MSLR query (80-159 documents) and the long
    set's queries of at most 512 documents only. g and h must agree
    within 1e-5 x max|g| (max|h|): both compute the same bf16-rounded
    pair factors, and the sums differ only in f32 order. Each is timed
    beside the twin."""
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops import rank as R
    from lightgbm_tpu_torch.ops.objectives import LambdarankNDCG
    rng = np.random.default_rng(21)
    long_counts = np.concatenate([[1, 2, 63, 64, 65, 129, 600, 2000, 5000,
                                   4999, 777], rng.integers(1, 300, 40)])
    long_y = rng.integers(0, 5, int(long_counts.sum())).astype(np.float32)
    cases = {"mslr": (y, group, 0), "long": (long_y, long_counts, 0),
             "mslr_lut1024": (y, group, 1024),
             "long_lut1024": (long_y, long_counts, 1024)}
    res = {}
    for name, (lab, grp, lut) in cases.items():
        md = Metadata(len(lab))
        md.set_label(lab)
        md.set_group(grp)
        obj = LambdarankNDCG(lt.Config.from_params(
            {"objective": "lambdarank", "tpu_rank_sigmoid_bins": lut}))
        obj.init(md, len(lab), torch.device(DEVICE))
        score = torch.as_tensor(rng.standard_normal(len(lab))
                                .astype(np.float32), device=DEVICE)
        args = (score, obj._qoff, obj._label_i, obj._gain, obj._inv,
                obj._disc, 1.0, lut, obj._lut_len)
        if lut and obj._lut_len != 512:
            raise AssertionError(f"lambdarank under auto on the card tables "
                                 f"queries up to {obj._lut_len} documents, "
                                 "not the default tile's 512")
        R.reset_launches()
        g, h = R.lambdarank_grad(*args, work=obj._work)
        g2, h2 = R.lambdarank_grad(*args, work=obj._work)
        gp, hp = R.lambdarank_grad_plain(*args)
        torch.cuda.synchronize()
        if R.LAUNCHES["lambdarank_grad"] != 2 or not torch.equal(g, g2) \
                or not torch.equal(h, h2):
            raise AssertionError(f"lambdarank_grad ({name}): two calls made "
                                 f"{R.LAUNCHES['lambdarank_grad']} launches "
                                 "or differ")
        mg, mh = gp.abs().max().item(), hp.abs().max().item()
        eg, eh = (g - gp).abs().max().item(), (h - hp).abs().max().item()
        if not (eg <= 1e-5 * mg and eh <= 1e-5 * mh):
            raise AssertionError(f"lambdarank_grad ({name}) differs from its "
                                 f"twin: max |dg| {eg} (max |g| {mg}), max "
                                 f"|dh| {eh} (max |h| {mh})")
        r = {"docs": len(lab), "queries": len(grp),
             "longest": int(np.max(grp)), "max_abs_err": max(eg, eh),
             "rel_err_g": eg / mg, "rel_err_h": eh / mh,
             "ms": cuda_ms(torch, lambda: R.lambdarank_grad(
                 *args, work=obj._work), reps=20),
             "tabled_up_to": obj._lut_len,
             "plain_ms": cuda_ms(torch, lambda: R.lambdarank_grad_plain(
                 *args), reps=2), "library_ms": None}
        r["bound_ms"], r["bound_by"], r["pairs_distinct"] = \
            rank_bound_ms(obj, lab)
        log(f"kernel lambdarank_grad ({name}: {r['docs']} docs, "
            f"{r['queries']} queries, longest {r['longest']}, sigmoid "
            f"table on queries up to {r['tabled_up_to']} documents): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library none, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['pairs_distinct']} pairs), max |dg|/max|g| "
            f"{r['rel_err_g']:.3e}, max |dh|/max|h| {r['rel_err_h']:.3e}")
        res[name] = r
        del obj, args, g, h, g2, h2, gp, hp
    torch.cuda.empty_cache()
    return res


def mslr_run(torch, lt, ds, params, rounds, X, y, group, what,
             **profile_kw) -> tuple:
    """One lambdarank ``train`` at the MSLR shape, timed per iteration,
    with every kernel count zeroed just before and read just after, and
    the plain twins of B2, B4 and B6 counted (a call on this path fails
    the run); NDCG@10 over the queries of the first 200,000 rows at the
    leaf-wise run's round count and at the end; one round profiled
    (`profile_round` with ``profile_kw``)."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import rank as R
    from lightgbm_tpu_torch.utils import log as port_log
    plain = {(A, "slot_hist_pass_plain"): 0, (A, "move_pass_plain"): 0,
             (R, "lambdarank_grad_plain"): 0}
    real = {key: getattr(*key) for key in plain}

    def counting(key):
        def fn(*args, **kw):
            plain[key] += 1
            return real[key](*args, **kw)
        return fn

    stamps, lines = [], []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in plain:
        setattr(*key, counting(key))
    port_log.register_callback(lines.append)
    try:
        H.reset_launches()
        A.reset_launches()
        R.reset_launches()
        t_start = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=rounds, callbacks=[stamp],
                       verbose_eval=False)
        launches = {"B1": H.LAUNCHES["f32"], **A.LAUNCHES, **R.LAUNCHES}
    finally:
        port_log.register_callback(None)
        for key in plain:
            setattr(*key, real[key])
    if any(plain.values()):
        raise AssertionError(f"{what}: plain twins ran on the card's path: "
                             f"{ {k[1]: v for k, v in plain.items()} }")
    iters = np.diff([t_start] + stamps)
    peak = torch.cuda.max_memory_allocated()
    g = bst._gbdt
    trees = bst.num_trees()
    if trees != rounds:
        raise AssertionError(f"{what}: {trees} trees after {rounds} rounds")
    if launches["lambdarank_grad"] < rounds:
        raise AssertionError(f"{what}: lambdarank_grad launched "
                             f"{launches['lambdarank_grad']} times in "
                             f"{rounds} rounds")
    qs, nrows = ndcg_queries(group, NDCG_ROWS)
    t0 = time.perf_counter()
    preds = bst.predict(X[:nrows])
    pred_s = time.perf_counter() - t0
    if not np.all(np.isfinite(preds)) or preds.shape != (nrows,):
        raise AssertionError(f"{what}: predictions are not finite of shape "
                             f"({nrows},)")
    r = {"first_round_s": float(iters[0]),
         "median_iter_ms": statistics.median(iters[1:]) * 1e3,
         "launches": launches,
         "launches_per_tree": {k: v / trees for k, v in launches.items()},
         "ndcg10": ndcg_at(preds, y[:nrows], qs),
         f"ndcg10_at_{MSLR_LEAF_ROUNDS}": ndcg_at(
             bst.predict(X[:nrows], num_iteration=MSLR_LEAF_ROUNDS),
             y[:nrows], qs),
         "peak_bytes": peak, "predict_s": pred_s,
         "train_path": g.train_path, "ndcg_queries": len(qs)}
    if g.train_path == "aligned":
        eng = g._aligned_eng
        r["rounds_per_tree"] = [st[0] for st in g.aligned_stats]
        r["splits_executed_per_tree"] = [st[1] for st in g.aligned_stats]
        r["fallbacks"] = eng.fallbacks
        r["layout_ext"] = bool(eng.ext)
        # the gradient round trip of one iteration, step by step: the
        # row-order score read, B6 (with the weights folded in), the
        # gather of g/h into the records by rid
        rs = eng.row_scores()
        gd, hd = g.objective.get_gradients(rs[None, :])
        r["round_trip_ms"] = {
            "row_scores": cuda_ms(torch, eng.row_scores),
            "gradients": cuda_ms(
                torch, lambda: g.objective.get_gradients(rs[None, :])),
            "gather": cuda_ms(
                torch, lambda: eng._gather_grad_lanes(gd[0], hd[0]))}
        del eng, rs, gd, hd
    r["path_logged"] = any(f"training path: {g.train_path}" in ln
                           for ln in lines)
    r["profile"] = profile_round(torch, bst, **profile_kw)
    del bst, g
    torch.cuda.empty_cache()
    return r


def phase_mslr(torch, lt, X, y, group) -> tuple:
    """lambdarank at the MSLR shape (2.27M x 137, 255 bins, 255 leaves):
    binning with the query groups, then ``train`` under the default
    ``auto`` (which must take the aligned engine on EXT records) and a
    leaf-wise run (pinned) on the same Dataset. NDCG@10 of both, at the
    leaf-wise run's round count, within 5e-3 of each other (the JAX
    package's tolerance, tests/test_rank_fused.py) and above an all-zero
    score's. Returns (Dataset, params, results)."""
    params = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 50, "metric": "none",
              "verbosity": 1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, group=group, params=params,
                    free_raw_data=False).construct()
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    res = {"binning_s": bin_s}
    res["aligned"] = a = mslr_run(torch, lt, ds, params, MSLR_ROUNDS, X, y,
                                  group, "MSLR auto")
    res["leafwise"] = w = mslr_run(
        torch, lt, ds, {**params, "tpu_grow_mode": "leafwise"},
        MSLR_LEAF_ROUNDS, X, y, group, "MSLR leaf-wise")
    qs, nrows = ndcg_queries(group, NDCG_ROWS)
    res["ndcg10_zero"] = zero = ndcg_at(np.zeros(nrows), y[:nrows], qs)
    if a["train_path"] != "aligned" or not a["layout_ext"] \
            or not a["path_logged"]:
        raise AssertionError(f"MSLR auto took {a['train_path']} (EXT "
                             f"{a.get('layout_ext')}, logged "
                             f"{a['path_logged']})")
    if a["launches"]["move_pass"] == 0 or a["launches"]["slot_hist_pass"] == 0:
        raise AssertionError(f"MSLR aligned launched {a['launches']}")
    at = f"ndcg10_at_{MSLR_LEAF_ROUNDS}"
    if abs(a[at] - w[at]) > 5e-3:
        raise AssertionError(f"MSLR aligned NDCG@10 {a[at]} is not within "
                             f"5e-3 of the leaf-wise {w[at]}")
    if not (a[at] > zero and w[at] > zero):
        raise AssertionError(f"MSLR NDCG@10 {a[at]} / {w[at]} not above the "
                             f"all-zero score's {zero}")
    for name, r in (("aligned (auto, EXT)", a), ("leaf-wise", w)):
        lp = r["launches_per_tree"]
        log(f"MSLR {name}: binning {bin_s:.3f} s, first round "
            f"{r['first_round_s']:.3f} s, median iteration "
            f"{r['median_iter_ms']:.1f} ms, rounds per tree "
            f"{r.get('rounds_per_tree', '-')}, fallbacks "
            f"{r.get('fallbacks', '-')}, launches per tree B6 "
            f"{lp['lambdarank_grad']:.1f} B2 {lp['move_pass']:.1f} B4 "
            f"{lp['slot_hist_pass']:.1f} B1 {lp['B1']:.1f}, NDCG@10 "
            f"{r['ndcg10']:.6f} ({len(qs)} queries; at "
            f"{MSLR_LEAF_ROUNDS} rounds {r[at]:.6f}, all-zero {zero:.6f}), "
            f"peak device memory {r['peak_bytes'] / 2**30:.3f} GiB")
    log(f"MSLR gradient round trip (aligned): "
        f"{ {k: round(v, 4) for k, v in a['round_trip_ms'].items()} } ms")
    return ds, params, res

# ---------------------------------------------------------------------------
# the prototype kernels P1-P3 and their harnesses
# ---------------------------------------------------------------------------
def phase_proto_path(torch) -> dict:
    """The port's prototype harnesses through their entry points at their
    own sizes: ``proto_aligned.main`` (10,485,760 rows, chunks of 256 and
    512, 384 slots: its correctness check, then P1 at four configurations
    and P2 over one block) and ``proto_roll.main`` (P3's two variants over
    20,000 chunks of 512). The kernel counts are zeroed just before and
    read just after; the plain twins are counted too (a call fails the
    run), and so does a failed correctness check."""
    from lightgbm_tpu_torch.ops import proto as P
    from lightgbm_tpu_torch.tools import proto_aligned, proto_roll
    plain = {name: 0 for name in ("slot_hist_plain", "move_plain",
                                  "ring_stage_plain")}
    real = {name: getattr(P, name) for name in plain}

    def counting(name):
        def fn(*args, **kw):
            plain[name] += 1
            return real[name](*args, **kw)
        return fn

    for name in plain:
        setattr(P, name, counting(name))
    try:
        P.reset_launches()
        t0 = time.perf_counter()
        aligned = proto_aligned.main(proto_aligned.N_ROWS, device=DEVICE)
        t1 = time.perf_counter()
        roll = proto_roll.main(proto_roll.N_CHUNKS, device=DEVICE)
        t2 = time.perf_counter()
        launches = dict(P.LAUNCHES)
    finally:
        for name in plain:
            setattr(P, name, real[name])
    if any(plain.values()):
        raise AssertionError(f"the prototype harnesses ran plain twins on "
                             f"the card: {plain}")
    if not aligned["ok"]:
        raise AssertionError("proto_aligned's correctness check failed")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"the prototype harnesses never launched {idle}")
    log(f"prototype harnesses: proto_aligned {t1 - t0:.3f} s, proto_roll "
        f"{t2 - t1:.3f} s (data made on the host included), launches "
        f"{launches}")
    return {"aligned": aligned, "roll": roll, "launches": launches,
            "aligned_s": t1 - t0, "roll_s": t2 - t1}


def proto_records(torch, nc: int, chunk: int, seed: int):
    """The correctness check's kind of records on the card, at full size:
    random words, normal g and |normal| h, valid rows per chunk between
    half and all of it."""
    from lightgbm_tpu_torch.ops import proto as P
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = torch.randint(0, 2**31 - 1, (nc, P.W, chunk), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    rec[:, P.LG] = torch.randn((nc, chunk), generator=gen,
                               device=DEVICE).view(torch.int32)
    rec[:, P.LH] = torch.randn((nc, chunk), generator=gen,
                               device=DEVICE).abs().view(torch.int32)
    cnts = torch.randint(chunk // 2, chunk + 1, (nc,), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    return rec, cnts


def proto_move_params(torch, rec, cnts):
    """(params, nc_out, valid rows, left rows) of P2 over one block of
    every chunk of ``rec``, split on byte 1 of word 1 at 127 as the
    harness does, left rows from chunk 0 and right rows after them."""
    from lightgbm_tpu_torch.ops import proto as P
    nc, _, chunk = rec.shape
    valid = torch.arange(chunk, device=DEVICE)[None, :] < cnts[:, None]
    rows = int(valid.sum())
    n_l = int(((((rec[:, 1] >> 8) & 255) <= 127) & valid).sum())
    base_r = -(-n_l // chunk)
    nc_out = base_r + -(-(rows - n_l) // chunk) + 1
    params = torch.zeros((nc, 8), dtype=torch.int32, device=DEVICE)
    params[:, P.P_WSEL] = 1
    params[:, P.P_SHIFT] = 8
    params[:, P.P_THR] = 127
    params[:, P.P_BASER] = base_r
    params[0, P.P_FIRST] = 1
    params[-1, P.P_LAST] = 1
    params[:, P.P_CNT] = cnts
    return params, nc_out, rows, n_l


def proto_slot_hist_library_ms(torch, words, slot, gh, num_slots: int,
                               num_features: int, b_pad: int) -> float:
    """One ``index_add_`` over a prebuilt flat index (slot, feature, bin)
    of the rows' contributing (feature, bin) cells: the yardstick."""
    f = torch.arange(num_features, device=DEVICE)
    binv = (words[:, f >> 2] >> ((f & 3) * 8)) & 255
    ok = binv < b_pad
    cell = ((slot[:, None] * num_features + f) * b_pad + binv)[ok]
    pay = torch.cat([gh, torch.ones_like(gh[:, :1])], 1)
    pay = pay[:, None, :].expand(-1, num_features, -1)[ok]
    out = torch.zeros((num_slots * num_features * b_pad, 3),
                      dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(torch, lambda: out.index_add_(0, cell, pay), reps=2)
    del binv, ok, cell, pay, out
    return ms


def proto_slot_hist_nonfinite(torch, rec, slots, cnts) -> dict:
    """P1 at (256, 4) on ``rec`` with g and h lanes of random non-negative
    int32 bits, as the TPU harness draws them: 1 value in 256 is NaN or
    Inf, so most runs of a slot take the kernel's f64 path. NaN and Inf
    cells where the twin has them, counts equal, finite g/h within 1e-5 x
    the slot's sum of finite |g| (|h|), in f64; timed."""
    from lightgbm_tpu_torch.ops import proto as P
    from lightgbm_tpu_torch.tools import proto_aligned as HA
    S, F = HA.NUM_SLOTS, HA.NUM_FEATURES
    bits = rec.clone()
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    bits[:, P.LG:P.LH + 1] = torch.randint(
        0, 2**31 - 1, bits[:, P.LG:P.LH + 1].shape, generator=gen,
        device=DEVICE, dtype=torch.int32)
    pay = bits[:, P.LG:P.LH + 1].view(torch.float32).double()
    valid = torch.arange(rec.shape[2], device=DEVICE)[None, :] \
        < cnts[:, None]
    ok = torch.isfinite(pay) & valid[:, None, :]
    nonfinite = int((~torch.isfinite(pay) & valid[:, None, :]).sum())
    scale = torch.zeros((S, 2), dtype=torch.float64, device=DEVICE) \
        .index_add_(0, slots.long(), torch.where(ok, pay.abs(), 0.0).sum(2))
    got = P.slot_hist(bits, slots, cnts, S, F, 256, 4)
    ref = P.slot_hist_plain(bits, slots, cnts, S, F, 256, 4)
    torch.cuda.synchronize()
    a, b = got[..., :2], ref[..., :2]
    fin = torch.isfinite(b)
    if not torch.equal(got[..., 2], ref[..., 2]) \
            or not torch.equal(torch.isfinite(a), fin) \
            or not torch.equal(a.isnan(), b.isnan()) \
            or not torch.equal(a[b.isinf()], b[b.isinf()]):
        raise AssertionError("slot_hist on non-finite payloads: counts or "
                             "NaN/Inf cells differ from its twin")
    err = torch.where(fin, (a.double() - b.double()).abs(), 0.0)
    if bool((err > 1e-5 * scale[:, None, None, :]).any()):
        raise AssertionError("slot_hist on non-finite payloads: finite g/h "
                             "differ beyond 1e-5 x the slot's sum |.|")
    r = {"nonfinite_values": nonfinite,
         "nonfinite_cells": int((~fin).sum()),
         "max_rel_err": float((err / scale[:, None, None, :]
                               .clamp_min(1e-300)).max()),
         "ms": cuda_ms(torch, lambda: P.slot_hist(bits, slots, cnts, S, F,
                                                  256, 4), reps=3)}
    log(f"kernel proto slot_hist (256, 4) on random-bit g/h "
        f"({nonfinite} non-finite values, {r['nonfinite_cells']} "
        f"non-finite cells, as its twin): {r['ms']:.4f} ms, max |d| / "
        f"slot sum {r['max_rel_err']:.3e}")
    return r


def ring_records(torch, kind: str, n: int = 20000, chunk: int = 512,
                 seed: int = 41):
    """P3's records on the card, [n, 16, chunk] random words (the
    harness's), or with lane 0's low byte set so that every chunk has
    no left row (``"no left"``), all but one (``"C-1 left"``: route4c
    skips positions below C lap after lap), or a row goes left with
    probability 1 / (8 chunk) (``"sparse left"``: the last 2C left rows
    span ~16 chunk chunks)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = torch.randint(0, 2**31 - 1, (n, 16, chunk), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    if kind == "random":
        return rec
    if kind == "no left":
        left = torch.zeros((n, chunk), dtype=torch.bool, device=DEVICE)
    elif kind == "C-1 left":
        left = torch.ones((n, chunk), dtype=torch.bool, device=DEVICE)
        left[torch.arange(n, device=DEVICE), torch.randint(
            0, chunk, (n,), generator=gen, device=DEVICE)] = False
    elif kind == "sparse left":
        left = torch.rand((n, chunk), generator=gen, device=DEVICE) \
            < 1.0 / (8 * chunk)
    else:
        raise ValueError(kind)
    key = rec[:, 0] & 255
    rec[:, 0] = (rec[:, 0] & ~255) | torch.where(left, key & 31,
                                                 32 + key % 224)
    return rec


def phase_proto_parity(torch) -> dict:
    """P1-P3 against their plain twins on the card at the harnesses'
    sizes, each timed beside the twin and its bound:

    - P1 ``slot_hist`` at the four configurations x chunks of 256 and 512
      over 10,485,760 rows in 384 slot runs, on the correctness check's
      kind of records: counts equal, g/h within 1e-5 x the slot's sum of
      |g| (|h|); beside one ``index_add_`` (the yardstick);
    - P2 ``move`` over one block of every chunk (split on byte 1 of word 1
      at 127, as the harness does), chunks of 256 and 512: both written
      into an output filled with -1, bit-equal everywhere (the covered
      rows, and the fill where neither writes);
    - P3 ``ring_stage`` at 20,000 x 512, both variants: the whole final
      staging bit-equal (both start from zeros); the launch alone with a
      warm and a cold L2, the wrapper, one kernel and no memset a call."""
    from lightgbm_tpu_torch.ops import proto as P
    from lightgbm_tpu_torch.tools import proto_aligned as HA
    from lightgbm_tpu_torch.tools import proto_roll as HR
    res = {"slot_hist": {}, "move": {}, "ring": {}}
    n = HA.N_ROWS
    S, F = HA.NUM_SLOTS, HA.NUM_FEATURES
    for chunk in HA.CHUNKS:
        nc = n // chunk
        rec, cnts = proto_records(torch, nc, chunk, 31 + chunk)
        slots = torch.as_tensor(HA.slot_map(nc), device=DEVICE)
        valid = torch.arange(chunk, device=DEVICE)[None, :] < cnts[:, None]
        rows = int(valid.sum())
        g = rec[:, P.LG].view(torch.float32)
        h = rec[:, P.LH].view(torch.float32)
        per_chunk = torch.stack([torch.where(valid, g.abs(), 0.0).sum(1),
                                 torch.where(valid, h.abs(), 0.0).sum(1)],
                                dim=1).double()
        scale = torch.zeros((S, 2), dtype=torch.float64, device=DEVICE) \
            .index_add_(0, slots.long(), per_chunk).float()
        c_idx, r_idx = valid.nonzero(as_tuple=True)
        words = rec[c_idx, :P.NWORDS, r_idx]
        gh = torch.stack([g[c_idx, r_idx], h[c_idx, r_idx]], dim=1)
        slot_of_row = slots.long()[c_idx]
        del c_idx, r_idx
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for b_pad, group in HA.CONFIGS:
            what = f"C={chunk} B={b_pad} group={group}"
            ctas = P.slot_hist_ctas_per_sm(
                0, P.slot_hist_smem(chunk, F, b_pad)[1])
            tile, smem, grid = P.slot_hist_launch_shape(
                nc, chunk, F, b_pad, ctas, sms)
            got = P.slot_hist(rec, slots, cnts, S, F, b_pad, group)
            ref = P.slot_hist_plain(rec, slots, cnts, S, F, b_pad, group)
            err = check_hist(torch, got, ref, scale, f"slot_hist {what}")
            del got, ref
            r = {"max_abs_err": err, "rows": rows,
                 "launch": {"tile_chunks": tile, "smem": smem,
                            "ctas_per_sm": ctas, "grid": grid},
                 "ms": cuda_ms(torch, lambda: P.slot_hist(
                     rec, slots, cnts, S, F, b_pad, group)),
                 "plain_ms": cuda_ms(torch, lambda: P.slot_hist_plain(
                     rec, slots, cnts, S, F, b_pad, group), reps=1),
                 "library_ms": proto_slot_hist_library_ms(
                     torch, words, slot_of_row, gh, S, F, b_pad)}
            r["bound_ms"], r["bound_by"] = bound(
                rows * (P.NWORDS + 2) * 4 + nc * 2 * 4
                + S * F * b_pad * 3 * 4, 3 * F * rows)
            res["slot_hist"][what] = r
            log(f"kernel proto slot_hist ({what}, {rows} rows, {S} slots): "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"index_add_ {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |d| "
                f"{err:.3e}, launch {r['launch']}")
        del words, gh, slot_of_row
        if chunk == HA.CHUNKS[0]:
            res["slot_hist_nonfinite"] = proto_slot_hist_nonfinite(
                torch, rec, slots, cnts)
        # ---- P2: one block of every chunk
        params, nc_out, _, n_l = proto_move_params(torch, rec, cnts)
        got = P.move(rec, params, nc_out,
                     out=torch.full((nc_out, P.W, chunk), -1,
                                    dtype=torch.int32, device=DEVICE))
        ref = P.move_plain(rec, params, nc_out,
                           out=torch.full_like(got, -1))
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"move C={chunk} differs from its twin")
        del ref
        # the launch alone (scratch allocated and params checked once),
        # the wrapper (with its host read of the params), then the work
        # one launch enqueues, from a captured graph
        from lightgbm_tpu_torch.utils.launches import graph_launches
        sc = P.move_scratch(rec)
        r = {"max_abs_err": 0.0, "rows": rows, "left_rows": n_l,
             "ms": cuda_ms(torch, lambda: P._move_cuda(
                 rec, params, nc_out, got, sc), reps=20),
             "wrapper_ms": cuda_ms(torch, lambda: P.move(
                 rec, params, nc_out, out=got)),
             "plain_ms": cuda_ms(torch, lambda: P.move_plain(
                 rec, params, nc_out, out=got), reps=1),
             "library_ms": None}
        graph = graph_launches(lambda: P._move_cuda(
            rec, params, nc_out, got, sc))
        if graph != {"kernels": 1, "memsets": 1, "other": 0}:
            raise AssertionError(f"move enqueued {graph}, not one memset "
                                 "and one kernel")
        r["launches_per_call"] = graph["kernels"] + graph["memsets"]
        r["bound_ms"], r["bound_by"] = bound(rows * P.W * 4 * 2
                                             + nc * 8 * 4, rows)
        res["move"][f"C={chunk}"] = r
        log(f"kernel proto move (C={chunk}, {rows} rows, {n_l} left, one "
            f"block): launch alone {r['ms']:.4f} ms (one memset, one "
            f"kernel), wrapper {r['wrapper_ms']:.4f} ms (with its params "
            f"check), plain {r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), bit-equal")
        del sc
        del rec, cnts, valid, got, params
        torch.cuda.empty_cache()
    # ---- P3
    from lightgbm_tpu_torch.utils.launches import graph_launches
    rec = ring_records(torch, "random", HR.N_CHUNKS, HR.C)
    rows = HR.N_CHUNKS * HR.C
    for variant in HR.VARIANTS:
        wrap = variant == "compact_roll"
        got = P.ring_stage(rec, wrap)
        ref = P.ring_stage_plain(rec, wrap)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            d = int((got != ref).any(0).sum())
            raise AssertionError(f"ring_stage {variant} differs from its "
                                 f"twin in {d} of {got.shape[1]} positions")
        written = int((P.ring_stage_plain(rec, wrap, fill=1) == ref)
                      .all(0).sum())
        # the launch alone with a warm and with a cold L2, the wrapper;
        # then the work one call enqueues, from a captured graph (after
        # the timing: a capture empties the allocator's cache)
        r = {"max_abs_err": 0.0, "rows": rows, "written": written,
             "ms": cuda_ms(torch, lambda: P._ring_cuda(rec, wrap, got),
                           reps=20),
             "cold_ms": cold_ms(torch, lambda: P._ring_cuda(rec, wrap, got)),
             "wrapper_ms": cuda_ms(torch, lambda: P.ring_stage(rec, wrap),
                                   reps=20),
             "plain_ms": cuda_ms(torch, lambda: P.ring_stage_plain(
                 rec, wrap), reps=2), "library_ms": None}
        graph = graph_launches(lambda: P._ring_cuda(rec, wrap, got))
        if graph != {"kernels": 1, "memsets": 0, "other": 0}:
            raise AssertionError(f"ring_stage {variant} enqueued {graph}, "
                                 "not one kernel")
        r["launches_per_call"] = graph["kernels"] + graph["memsets"]
        # the output depends on lane 0 of every row and on the whole of
        # the rows that end in the staging, which is all a kernel must read
        r["bound_ms"], r["bound_by"] = bound(
            rows * 4 + written * P.W * 4 + P.W * 4 * HR.C * 4, rows)
        res["ring"][variant] = r
        log(f"kernel proto ring_stage ({variant}, {HR.N_CHUNKS} x {HR.C}, "
            f"{written} of {4 * HR.C} positions written): launch alone "
            f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} cold, wrapper "
            f"{r['wrapper_ms']:.4f}, one kernel a call, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; every lane of "
            f"every row would be {bound(rows * P.W * 4, rows)[0]:.4f} ms), "
            f"bit-equal")
        del got, ref
    del rec
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# multiclass: softmax and one-vs-all at the Covertype shape
# ---------------------------------------------------------------------------
# UCI Covertype (Blackard 1998; the multiclass table of the GPU GBDT
# papers): 581,012 rows, 7 cover types at their published shares, ten
# numerical columns in their published ranges, and the 4 Wilderness_Area
# and 40 Soil_Type one-hot columns folded back into two categorical ones
COVTYPE_ROWS = 581_012
COVTYPE_SHARES = (0.36461, 0.48760, 0.06154, 0.00473, 0.01634, 0.02989,
                  0.03530)
COVTYPE_RANGES = ((1859, 3858), (0, 360), (0, 66), (0, 1397), (-173, 601),
                  (0, 7117), (0, 254), (0, 254), (0, 254), (0, 7173))
COVTYPE_CODES = (4, 40)
COVTYPE_CATS = [10, 11]
# rounds of each run; cut (from 10, 5, 5, 5, 5, 3 and 5) to make room for
# phase 18 in the run's time limit, and the leaf-wise run from 2 to 1 for
# phase 19: it takes 20-29 s an iteration at this shape on an H100 80GB
# HBM3 at 700 W, so (a) and (c) are compared at MC_COMPARE rounds
# cut from 5 and 3 to make room for phase 20
MC_ROUNDS = {"auto": 3, "auto_255": 2, "leafwise": 1, "ova": 2, "bag": 2,
             "ova_bag": 2, "level": 2}
MC_COMPARE = 1
MC_KERNEL_ROWS = 10_485_760
MC_PARAMS = {"objective": "multiclass", "num_class": 7, "num_leaves": 255,
             "learning_rate": 0.1, "min_data_in_leaf": 20,
             "feature_fraction": 1.0, "verbosity": -1}


def synth_covtype(n: int, seed: int = 17):
    """A Covertype-shaped table: the cover type drawn at the published
    shares, each numerical column a class-dependent draw clipped to its
    published range and rounded to an integer (the table's columns are
    integers), Wilderness_Area and Soil_Type drawn from class-dependent
    Dirichlet shares; Elevation, the table's strongest column, the most
    class-dependent. Returns (X f32 [n, 12], y f64 [n])."""
    rng = np.random.default_rng(seed)
    shares = np.asarray(COVTYPE_SHARES) / sum(COVTYPE_SHARES)
    cls = rng.choice(len(shares), n, p=shares)
    X = np.empty((n, 12), np.float32)
    centers = rng.uniform(0.2, 0.8, (len(shares), len(COVTYPE_RANGES)))
    for j, (lo, hi) in enumerate(COVTYPE_RANGES):
        sd = 0.06 if j == 0 else 0.2
        v = np.clip(centers[cls, j] + sd * rng.standard_normal(n), 0, 1)
        X[:, j] = np.round(lo + (hi - lo) * v)
    for j, codes in zip(COVTYPE_CATS, COVTYPE_CODES):
        p = rng.dirichlet(np.full(codes, 0.5), len(shares))
        for k in range(len(shares)):
            idx = np.nonzero(cls == k)[0]
            X[idx, j] = rng.choice(codes, idx.size, p=p[k])
    return X, cls.astype(np.float64)


def mc_metrics(lt, raw, yte, objective) -> dict:
    """Holdout multi_logloss and multi_error of [N, K] raw scores, by the
    port's metrics (the objective's output transform)."""
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops.metrics import create_metrics
    md = Metadata(len(yte))
    md.set_label(yte)
    out = {}
    for m in create_metrics(objective.cfg, ["multi_logloss", "multi_error"]):
        m.init(md, len(yte))
        out[m.name] = m.eval(np.ascontiguousarray(raw.T), objective)[0][1]
    return out


def mc_run(torch, lt, ds, params, rounds, Xte, yte, what, path,
           mode=None, bagged=False) -> tuple:
    """One multiclass ``train`` on the card, timed per iteration, the
    kernel counts (and the class kinds' apart) zeroed just before and read
    just after, the log's training path read: it must take ``path``
    (aligned: K builds an iteration, in lane ``mode``, the bag as asked);
    holdout metrics; [N, K] finite predictions (softmax rows summing to
    1) and the card's against a CPU predict of the model text."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils import log as port_log
    K = params["num_class"]
    stamps, lines = [], []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    H.reset_launches()
    A.reset_launches()
    port_log.register_callback(lines.append)
    try:
        t_start = time.perf_counter()
        bst = lt.train({**params, "verbosity": 1}, ds,
                       num_boost_round=rounds, callbacks=[stamp],
                       verbose_eval=False)
    finally:
        port_log.register_callback(None)
    launches = {"B1": H.LAUNCHES["f32"], **A.LAUNCHES,
                "B5": sum(H.WORDS_LAUNCHES.values()),
                **{f"{k}_class": v for k, v in A.CLASS_LAUNCHES.items()}}
    g = bst._gbdt
    if g.train_path != path or not any(f"training path: {path}" in ln
                                       for ln in lines):
        raise AssertionError(f"{what}: took {g.train_path}, not {path}")
    if bst.num_trees() != rounds * K:
        raise AssertionError(f"{what}: {bst.num_trees()} trees after "
                             f"{rounds} rounds of {K} classes")
    iters = np.diff([t_start] + stamps)
    # a run of one round has no iteration after its first
    r = {"first_round_s": float(iters[0]),
         "median_iter_ms": statistics.median(
             iters[1:] if len(iters) > 1 else iters) * 1e3,
         "launches": launches, "peak_bytes": torch.cuda.max_memory_allocated()}
    if path == "aligned":
        eng = g._aligned_eng
        if eng.num_class != K or eng.mc_mode != mode \
                or eng.bagged != bagged:
            raise AssertionError(f"{what}: the engine has {eng.num_class} "
                                 f"classes in mode {eng.mc_mode}, bagged "
                                 f"{eng.bagged}")
        stats = g.aligned_stats
        r["builds_per_iteration"] = len(stats) / rounds
        r["rounds_per_tree"] = [s[0] for s in stats]
        r["fallbacks"] = eng.fallbacks
        if not (launches["slot_hist_pass_class"]
                == launches["slot_hist_pass"] > 0
                and launches["move_pass_class"] == launches["move_pass"] > 0):
            raise AssertionError(f"{what}: launches {launches}")
        if bagged and not (launches["slot_hist_pass_bag"]
                           == launches["slot_hist_pass"]
                           and launches["count_pass"] > 0):
            raise AssertionError(f"{what}: the bag branch and B3 did not "
                                 f"run: {launches}")
    elif path == "level":
        r["fallbacks"] = g.learner.level_fallbacks
        if launches["B5"] == 0:
            raise AssertionError(f"{what}: B5 never launched")
    elif launches["B1"] == 0:
        raise AssertionError(f"{what}: B1 never launched")
    t0 = time.perf_counter()
    raw = bst.predict(Xte, raw_score=True)
    r["predict_s"] = time.perf_counter() - t0
    prob = bst.predict(Xte[:4000])
    if raw.shape != (len(yte), K) or not np.all(np.isfinite(raw)) \
            or not np.all(np.isfinite(prob)):
        raise AssertionError(f"{what}: predictions not finite of shape "
                             f"({len(yte)}, {K})")
    if params["objective"] == "multiclass" and not np.allclose(
            prob.sum(1), 1.0, atol=1e-6):
        raise AssertionError(f"{what}: softmax rows do not sum to 1")
    cpu = lt.Booster(model_str=bst.model_to_string(),
                     params={"device_type": "cpu"})
    np.testing.assert_allclose(bst.predict(Xte[:4000], raw_score=True),
                               cpu.predict(Xte[:4000], raw_score=True),
                               rtol=1e-5, atol=1e-7)
    r.update(mc_metrics(lt, raw, yte, g.objective))
    if rounds >= MC_COMPARE:
        r["at_compare"] = mc_metrics(lt, bst.predict(
            Xte, raw_score=True, num_iteration=MC_COMPARE), yte,
            g.objective)
    lp = {k: v / bst.num_trees() for k, v in launches.items()}
    log(f"{what}: first round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms over {rounds - 1}, "
        + (f"{r['builds_per_iteration']:.0f} builds an iteration, rounds "
           f"per tree {r['rounds_per_tree']}, " if path == "aligned"
           else "")
        + f"fallbacks {r.get('fallbacks', 0)}, launches per tree B2 "
        f"{lp['move_pass']:.1f} B3 {lp['count_pass']:.1f} B4 "
        f"{lp['slot_hist_pass']:.1f} B1 {lp['B1']:.1f} B5 {lp['B5']:.1f}, "
        f"holdout multi_logloss {r['multi_logloss']:.6f} multi_error "
        f"{r['multi_error']:.6f}, predict {r['predict_s']:.3f} s, peak "
        f"device memory {r['peak_bytes'] / 2**30:.3f} GiB")
    return bst, r


def phase_multiclass(torch, lt, holdout_share: float = 0.1) -> dict:
    """Phase 17's runs (a)-(g) at the Covertype shape."""
    t_phase = time.perf_counter()
    X, y = synth_covtype(COVTYPE_ROWS)
    n_tr = COVTYPE_ROWS - int(holdout_share * COVTYPE_ROWS)
    Xtr, ytr, Xte, yte = X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
    res = {"rows": n_tr, "holdout": len(yte),
           "shares": np.bincount(ytr.astype(int), minlength=7).tolist()}
    for max_bin, key in ((63, "auto"), (255, "auto_255")):
        params = {**MC_PARAMS, "max_bin": max_bin}
        t0 = time.perf_counter()
        ds = lt.Dataset(Xtr, label=ytr, params=params,
                        categorical_feature=COVTYPE_CATS,
                        free_raw_data=False).construct()
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        bst, r = mc_run(torch, lt, ds, params, MC_ROUNDS[key], Xte, yte,
                        f"multiclass auto {max_bin} ({'ab'[key != 'auto']})",
                        "aligned", "prob")
        r["binning_s"] = bin_s
        if key == "auto":
            # one profiled round (cut from one a bin count for phase 19)
            r["profile"] = profile_round(torch, bst)
        res[key] = r
        del bst
        if max_bin == 255:
            break
        # (c) leaf-wise; (d) one-vs-all; (e) bagged; (f) level
        for key2, extra, path, mode, bagged in (
                ("leafwise", {"tpu_grow_mode": "leafwise"}, "leafwise",
                 None, False),
                ("ova", {"objective": "multiclassova"}, "aligned", "score",
                 False),
                ("bag", BAG, "aligned", "prob", True),
                ("ova_bag", {"objective": "multiclassova", **BAG},
                 "aligned", "score", True),
                ("level", {"tpu_grow_mode": "level", "max_depth": 8},
                 "level", None, False)):
            bst, res[key2] = mc_run(
                torch, lt, ds, {**params, **extra}, MC_ROUNDS[key2], Xte,
                yte, f"multiclass {key2} 63", path, mode, bagged)
            del bst
        a5, c5 = res["auto"]["at_compare"], res["leafwise"]["at_compare"]
        for m in ("multi_logloss", "multi_error"):
            if abs(a5[m] - c5[m]) > 2e-3:
                raise AssertionError(f"multiclass auto {m} at {MC_COMPARE} "
                                     f"rounds {a5[m]} is not within 2e-3 of "
                                     f"leaf-wise {c5[m]}")
        log(f"  multiclass auto (a) at {MC_COMPARE} rounds: {a5} against "
            f"leaf-wise {c5}")
        del ds
        torch.cuda.empty_cache()
    # (g) f64 leaf-wise at 20,000 rows: the card's trees are the CPU's
    texts = {}
    for dev in ("cuda", "cpu"):
        bst = lt.train({**MC_PARAMS, "num_leaves": 31, "max_bin": 63,
                        "tpu_use_f64_hist": True,
                        "tpu_grow_mode": "leafwise", "device_type": dev},
                       lt.Dataset(X[:20000], label=y[:20000],
                                  categorical_feature=COVTYPE_CATS),
                       num_boost_round=3, verbose_eval=False)
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    if texts["cuda"] != texts["cpu"]:
        raise AssertionError("multiclass f64 trees differ between cuda and "
                             "cpu")
    log("  multiclass f64 (g): cuda and cpu trees equal (20,000 rows, 3 "
        "rounds of 7 trees)")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"multiclass phase (Covertype shape): {res['phase_s']:.1f} s")
    return res


def phase_mc_parity(torch, lt) -> dict:
    """The class-lane kinds of B4 (the root) and of B2's smaller-child
    histograms, softmax ("prob") and one-vs-all ("score"), unbagged and
    with the bag bit, against their twins on one iteration of the
    Covertype-shaped table drawn at 10,485,760 rows (63 bins), its second
    iteration (the first's scores give the payloads many values); B2's
    partition at W = 24 (K = 7) and on K = 31 records; B3 on the bagged
    K-class COMPACT records. Each timed beside the twin, the byte bound
    and one ``index_add_``."""
    from lightgbm_tpu_torch.ops import aligned as A
    t_phase = time.perf_counter()
    X, y = synth_covtype(MC_KERNEL_ROWS)
    params = {**MC_PARAMS, "max_bin": 63}
    ds = lt.Dataset(X, label=y, params=params,
                    categorical_feature=COVTYPE_CATS).construct()
    del X
    res = {}
    for obj, kind in (("multiclass", "prob"), ("multiclassova", "score")):
        for bagged in (False, True):
            tag = kind + ("_bag" if bagged else "")
            what = f"{tag}, {MC_KERNEL_ROWS}x12, 63 bins"
            calls = capture_kernel_calls(
                torch, lt, ds, {**params, "objective": obj,
                                **(BAG if bagged else {})}, skip=1)
            gh, bl = calls["gh_off"], calls["bag_lane"]
            if bl != (-2 if bagged else -1):
                raise AssertionError(f"{what}: bag_lane {bl}")
            # ---- B4's class lanes: the root pass of class 0
            args = calls["slot_hist_pass"]
            rec, slots, meta, k, F, B, wcnt, bits, grad = args
            if not isinstance(grad, A.ClassGrad) or grad.kind != kind:
                raise AssertionError(f"{what}: the engine passed {grad}")
            nc, W, C = rec.shape
            kw = {"gh_off": gh, "bag_lane": bl}
            err = check_hist(torch, A.slot_hist_pass(*args, **kw),
                             A.slot_hist_pass_plain(*args, **kw),
                             slot_abs_sums(torch, A, rec, slots, meta, k,
                                           wcnt, grad, gh, bl),
                             f"slot_hist_pass root, {what}")
            valid = A._valid_rows(meta, C)
            rows = int(valid.sum())
            inbag = int((valid & A._in_bag(rec, wcnt, bl, grad.meta_lane)
                         ).sum()) if bagged else rows
            r = {"max_abs_err": err, "rows": rows, "in_bag_rows": inbag,
                 "W": W, "ms": cuda_ms(torch, lambda: A.slot_hist_pass(
                     *args, **kw)),
                 "plain_ms": cuda_ms(torch, lambda: A.slot_hist_pass_plain(
                     *args, **kw), reps=2),
                 "library_ms": hist_library_ms(torch, A, rec, slots, meta, k,
                                               F, B, wcnt, bits, grad, gh,
                                               bl)}
            # every valid row's meta word (label and bag), the in-bag
            # rows' bin words and class lane
            r["bound_ms"], r["bound_by"] = bound(
                rows * 4 + inbag * (wcnt + 1) * 4 + nc * 2 * 4
                + k * F * B * 3 * 4, 3 * F * inbag)
            res[f"slot_hist_{tag}"] = r
            # ---- B2: the widest round's move (of any class's tree), its
            # children alone with that class's payload
            args = calls["move_wide"]
            err = check_move(torch, A, args, f"move_pass wide, {what}", gh,
                             cbits=calls["move_wide_cbits"], bag_lane=bl)
            rec, meta, k, w_used = args[0], args[5], args[8], args[13]
            grad = args[14]
            buf = torch.empty_like(rec)
            part = (*args[:8], k, bits, w_used, buf)
            cb = calls["move_wide_cbits"]
            cptr = A._cbits_ptr(cb, rec, k)
            nslot, ncnt = A._move_partition_cuda(*part, cptr)
            child = (nslot, ncnt, k, F, B, wcnt, bits, grad)
            _, ref = A.move_pass_plain(*args, gh_off=gh, bag_lane=bl,
                                       cbits=cb)
            err = max(err, check_hist(
                torch, A._slot_hist_cuda(buf, *child, gh, bl), ref,
                slot_abs_sums(torch, A, buf, nslot, ncnt, k, wcnt, grad, gh,
                              bl), f"child histograms alone, wide, {what}"))
            del ref
            mapped = ncnt > 0
            crows = int(ncnt[mapped].sum())
            cvalid = A._valid_rows(ncnt, C) & mapped[:, None]
            cinbag = int((cvalid & A._in_bag(buf, wcnt, bl, grad.meta_lane)
                          ).sum()) if bagged else crows
            r = {"max_abs_err": err, "rows": crows, "in_bag_rows": cinbag,
                 "children": int(torch.unique(nslot[mapped]).numel()),
                 "ms": cuda_ms(torch, lambda: A._slot_hist_cuda(
                     buf, *child, gh, bl)),
                 "plain_ms": cuda_ms(torch, lambda: A.slot_hist_pass_plain(
                     buf, *child, gh_off=gh, bag_lane=bl), reps=2),
                 "library_ms": hist_library_ms(torch, A, buf, nslot, ncnt,
                                               k, F, B, wcnt, bits, grad, gh,
                                               bl)}
            r["bound_ms"], r["bound_by"] = bound(
                crows * 4 + cinbag * (wcnt + 1) * 4 + nc * 2 * 4
                + k * F * B * 3 * 4, 3 * F * cinbag)
            res[f"child_hist_{tag}"] = r
            if tag == "prob":
                # ---- B2's partition at W = 24 (K = 7) on the widest
                # round, then on K = 31 records of the same rows
                r1 = args[1]
                cnt = meta & 0xFFFFF
                is_copy = ((r1 >> 16) & 1) == 1
                split_rows = int(cnt[~is_copy].sum())
                copy_chunks = int((is_copy & (cnt > 0)).sum())
                no_hist = (*args[:8], 0, *args[9:])
                r = {"max_abs_err": 0.0, "split_rows": split_rows,
                     "copy_chunks": copy_chunks, "W": W, "w_used": w_used,
                     "ms": cuda_ms(torch, lambda: A._move_partition_cuda(
                         *part, cptr), reps=20),
                     "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
                         *no_hist, out=buf, gh_off=gh, cbits=cb), reps=2),
                     "library_ms": None}
                r["bound_ms"], r["bound_by"] = bound(
                    2 * (split_rows + copy_chunks * C) * w_used * 4
                    + nc * 9 * 4, 0)
                res["partition"] = r
                r.update(mc_partition_k31(torch, A, calls, gh))
            del buf, nslot, ncnt, child
            # ---- B3 on bagged K-class COMPACT records
            if tag == "prob_bag":
                args = calls["count_wide"]
                cb = calls["count_wide_cbits"]
                got = A.count_pass(*args, cbits=cb)
                if not torch.equal(got, A.count_pass_plain(*args, cbits=cb)):
                    raise AssertionError(f"count_pass differs from its "
                                         f"twin, {what}")
                cmeta, ks, k = args[3], args[5], args[6]
                crows = int((cmeta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
                alone = torch.empty(k, dtype=torch.int32, device=DEVICE)
                cptr = A._cbits_ptr(cb, args[0], k)
                r = {"max_abs_err": 0.0, "rows": crows,
                     "ms": cuda_ms(torch, lambda: A._count_cuda(
                         *args, alone, cptr), reps=20),
                     "cold_ms": cold_ms(torch, lambda: A._count_cuda(
                         *args, alone, cptr)),
                     "wrapper_ms": cuda_ms(torch, lambda: A.count_pass(
                         *args, cbits=cb), reps=20),
                     "plain_ms": cuda_ms(torch, lambda: A.count_pass_plain(
                         *args, cbits=cb), reps=2),
                     "library_ms": None}
                r["bound_ms"], r["bound_by"] = bound(
                    crows * 4 + nc * 5 * 4 + k * 4, crows)
                res["count_bag"] = r
            del calls
            torch.cuda.empty_cache()
    for name, r in res.items():
        extra = {key: v for key, v in r.items() if key not in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"kernel {name} (multiclass, {MC_KERNEL_ROWS}x12, 63 bins): "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max |d| {r['max_abs_err']:.3e}, {extra}")
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"multiclass kernel phase: {res['phase_s']:.1f} s")
    return res


def mc_partition_k31(torch, A, calls, gh) -> dict:
    """B2's partition on K = 31 softmax records of the same rows in the
    same layout as the K = 7 root move (W = 72: 3 bin words, 31 score,
    31 probability and 1 meta lane; more than a stage of a CTA holds, so
    the lanes go in turns; the K = 7 records' bin words and meta lane,
    their 14 score and probability lanes repeated), with that move's
    route words: the moved records equal the twin's on the rows the
    layout covers."""
    K = 31
    args = calls["move_root"]
    rec7, wcnt, bits, grad7 = args[0], args[11], args[12], args[14]
    nc, _, C = rec7.shape
    lanes, W = A.lane_layout(wcnt, compact=True, num_class=K, with_prob=True)
    full = torch.zeros((nc, W, C), dtype=torch.int32, device=DEVICE)
    full[:, :wcnt] = rec7[:, :wcnt]
    full[:, lanes["meta"]] = rec7[:, grad7.meta_lane]
    src = rec7[:, wcnt:grad7.meta_lane]
    for j in range(2 * K):
        full[:, wcnt + j] = src[:, j % src.shape[1]]
    w_used = lanes["meta"] + 1
    grad = A.ClassGrad("prob", 0, lanes["prob"], lanes["meta"])
    a31 = (full, *args[1:11], wcnt, bits, w_used, grad)
    cb = calls["move_root_cbits"]
    err = check_move(torch, A, a31, f"move_pass root, K = {K} records", gh,
                     cbits=cb)
    buf = torch.empty_like(full)
    k = args[8]
    part = (*a31[:8], k, bits, w_used, buf, A._cbits_ptr(cb, full, k))
    meta, r1 = args[5], args[1]
    cnt = meta & 0xFFFFF
    is_copy = ((r1 >> 16) & 1) == 1
    rows = int(cnt[~is_copy].sum())
    copies = int((is_copy & (cnt > 0)).sum())
    ms = cuda_ms(torch, lambda: A._move_partition_cuda(*part), reps=20)
    lanes_stage, smem = A.move_smem(full.shape[2], w_used,
                                    A._lib()["lgbt_aligned_smem_optin"](0))
    b_ms, _ = bound(2 * (rows + copies * full.shape[2]) * w_used * 4
                    + meta.numel() * 9 * 4, 0)
    del full, buf
    log(f"  B2 partition, K = {K}: W {W}, {w_used} lanes used, "
        f"{lanes_stage} lanes a stage ({smem} B), kernel {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms, {rows} rows")
    return {"k31_W": W, "k31_w_used": w_used, "k31_lanes_a_stage":
            lanes_stage, "k31_ms": ms, "k31_bound_ms": b_ms,
            "k31_max_abs_err": err}

# ---------------------------------------------------------------------------
# phase 18: B1's integer branch, quantized training, forced splits and
# CEGB, early stopping
# ---------------------------------------------------------------------------
# a three-level forced-splits JSON on HIGGS features (its thresholds in the
# features' own units: the first 21 columns are standard normal)
FORCED_HIGGS = {
    "feature": 0, "threshold": 0.0,
    "left": {"feature": 1, "threshold": -0.5,
             "left": {"feature": 5, "threshold": 0.3}},
    "right": {"feature": 2, "threshold": 0.5,
              "right": {"feature": 3, "threshold": -0.2}}}
# the CEGB options of phase 18 (c): a split penalty and a coupled penalty a
# feature, the last seven features (the |products|) the dearest
CEGB_HIGGS = {"cegb_penalty_split": 1e-6, "cegb_tradeoff": 1.0,
              "cegb_penalty_feature_coupled": [0.5] * 21 + [4.0] * 7}
# cut from 5 to make room for phase 19
Q_ROUNDS = 3
CUT_ROUNDS = 3     # the 20,000-row cuts' rounds (31 leaves), CPU beside


def int_bound_ms(count: int, f: int, bins: int, itemsize: int,
                 indexed: bool):
    """Least time for one call of B1's integer branch on this card: the
    leaf's bins rows, its int8/int16 (g, h) pairs and its indices read
    once, the f32 output written once, against 3 adds a (row, feature)
    at the f32 rate outside the tensor cores."""
    nbytes = count * (f + 2 * itemsize + (4 if indexed else 0)) \
        + f * bins * 3 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * f * count / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_quant_parity(torch, dev, rows: int) -> dict:
    """Phase 18 (a): B1's integer branch against its twin at the HIGGS
    shape (``rows`` x 28), 63 and 255 bins, int8 and int16, over the
    contiguous root and a gathered leaf of 20,000 rows: bit-equal; warm
    and cold ms, the kernels and memsets one call enqueues (a captured
    CUDA graph), the twin's ms, one int64 ``index_add_`` over a prebuilt
    flat index (the yardstick) and the byte bound; the SASS atomics of
    ``hist_int_kernel``, which must hold no compare-and-swap loop."""
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils import prng
    from lightgbm_tpu_torch.utils.launches import graph_launches
    t_phase = time.perf_counter()
    f, n = 28, rows
    gen = torch.Generator(device=dev).manual_seed(18)
    res = {}
    for bins in (63, 255):
        binm = torch.randint(0, bins, (n, f), generator=gen, device=dev,
                             dtype=torch.uint8)
        gh = leaf_gh(torch, n, 18 + bins, dev)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        for bits in (8, 16):
            q, _ = H.quantize_gh(gh, bits, prng.fold_in(prng.key(1), 1))
            for what, idx, begin, count in (("root", None, 0, n),
                                            ("leaf", perm, n // 16 + 7,
                                             min(20_000, n // 4))):
                def kern():
                    return H.leaf_histogram(binm, q, idx, begin, count,
                                            bins)

                got = kern()
                ref = H.histogram_plain(binm, q, idx, begin, count, bins)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    d = (got - ref).abs().max().item()
                    raise AssertionError(f"B1 int{bits} {what}, {bins} "
                                         f"bins, differs from its twin: "
                                         f"max |d| {d}")
                rows_ = (idx[begin:begin + count].long() if idx is not None
                         else torch.arange(count, device=dev))
                cell = (binm[rows_].long() + torch.arange(f, device=dev)
                        * bins).reshape(-1)
                pay = torch.cat([q[rows_].long(), torch.ones(
                    (count, 1), dtype=torch.int64, device=dev)], 1)
                pay = pay[:, None, :].expand(-1, f, -1).reshape(-1, 3)
                acc = torch.zeros((f * bins, 3), dtype=torch.int64,
                                  device=dev)
                b_ms, b_by = int_bound_ms(count, f, bins, bits // 8,
                                          idx is not None)
                r = {"rows": count, "max_abs_err": 0.0,
                     "ms": cuda_ms(torch, kern, reps=10),
                     "cold_ms": cold_ms(torch, kern),
                     "plain_ms": cuda_ms(torch, lambda: H.histogram_plain(
                         binm, q, idx, begin, count, bins), reps=2),
                     "library_ms": cuda_ms(
                         torch, lambda: acc.index_add_(0, cell, pay),
                         reps=2),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "graph": graph_launches(kern)}
                del cell, pay, acc, rows_
                res[f"{bins} int{bits} {what}"] = r
                log(f"kernel B1 int{bits} {what} {count}x{f}, {bins} bins: "
                    f"equal to the twin, warm {r['ms']:.4f} ms, cold "
                    f"{r['cold_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                    f"index_add_ {r['library_ms']:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}), a call {r['graph']}")
                if r["graph"] != {"kernels": 1, "memsets": 0, "other": 0}:
                    raise AssertionError(f"B1 int{bits}: one call enqueued "
                                         f"{r['graph']}")
            del q
        del binm, gh, perm
        torch.cuda.empty_cache()
    res["sass"] = sass_atomics("histogram", "hist_int_kernel", whole=False)
    if any("CAS" in op or "CAST" in op for op in res["sass"]):
        raise AssertionError("sass: hist_int_kernel holds a "
                             "compare-and-swap loop")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 (a): {res['phase_s']:.1f} s")
    return res


def tree_sections(bst) -> str:
    t = bst.model_to_string()
    return t[t.index("Tree=0"):t.index("end of trees")]


def phase_quant_train(torch, lt, ds, params, X, y, rows: int,
                      leaf: dict) -> dict:
    """Phase 18 (b): ``tpu_quant_hist=on`` at 16 and 8 bits, leaf-wise at
    the HIGGS shape (255 leaves, 63 bins), Q_ROUNDS each, the B1 counts
    zeroed just before and read just after; holdout AUC within 2e-3 of
    the f32 leaf-wise run's at Q_ROUNDS (phase 4); one profiled round of
    the 8-bit run (B1's integer kernel launched once an integer call);
    then on a 20,000-row cut the card's predictions against the CPU port's, the
    same leaves, and whether the tree sections are equal."""
    from lightgbm_tpu_torch.ops import histogram as H
    t_phase = time.perf_counter()
    Xte, yte = X[rows:], y[rows:]
    res = {}
    for bits in (16, 8):
        qp = {**params, "tpu_grow_mode": "leafwise", "tpu_quant_hist": "on",
              "tpu_quant_hist_bits": bits}
        bst, r = train_run(torch, lt, ds, qp, Q_ROUNDS, Xte, yte,
                           f"quantized {bits}")
        r["launches"][f"B1_i{bits}"] = H.INT_LAUNCHES[f"i{bits}"]
        if r["launches"][f"B1_i{bits}"] == 0 or r["launches"]["B1"]:
            raise AssertionError(f"quantized {bits}: B1 launches "
                                 f"{r['launches']}")
        if bst._gbdt.learner.quant_bits != bits:
            raise AssertionError(f"quantized {bits}: the learner did not "
                                 "quantize")
        r["auc_f32_at_q"] = leaf["auc_at_q"]
        if abs(r["auc"] - leaf["auc_at_q"]) > 2e-3:
            raise AssertionError(f"quantized {bits}: holdout AUC {r['auc']} "
                                 f"not within 2e-3 of the f32 run's "
                                 f"{leaf['auc_at_q']}")
        prof = ""
        if bits == 8:
            # one profiled round (~70,000 launches: the profiler's own
            # cost is tens of seconds a round)
            r["profile"] = profile_round(torch, bst)
            hk = r["profile"]["hist_kernels"].get(
                "hist_int_kernel", {"ms": 0.0, "launches": 0})
            prof = (f", profiled round B1 {hk['ms']:.3f} ms in "
                    f"{hk['launches']} launches")
        log(f"phase 18 (b) int{bits}: median iteration "
            f"{r['median_iter_ms']:.1f} ms, first round "
            f"{r['first_round_s']:.3f} s, B1 launches "
            f"{r['launches'][f'B1_i{bits}']}, holdout AUC {r['auc']:.6f} "
            f"(f32 at {Q_ROUNDS} rounds {leaf['auc_at_q']:.6f}){prof}")
        res[bits] = r
        del bst
        torch.cuda.empty_cache()
    # the 20,000-row cut: the card against the CPU port
    cut = {}
    for bits in (16, 8):
        p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
             "tpu_grow_mode": "leafwise", "tpu_quant_hist": "on",
             "tpu_quant_hist_bits": bits, "verbosity": -1}
        out = {}
        for dev_t in ("cuda", "cpu"):
            out[dev_t] = lt.train({**p, "device_type": dev_t},
                                  lt.Dataset(X[:20000], label=y[:20000]),
                                  num_boost_round=CUT_ROUNDS,
                                  verbose_eval=False)
        a, b = out["cuda"], out["cpu"]
        pa = a.predict(Xte[:4000], raw_score=True)
        pb = b.predict(Xte[:4000], raw_score=True)
        leaves = [t.num_leaves for t in a.trees]
        if leaves != [t.num_leaves for t in b.trees]:
            raise AssertionError(f"quantized cut {bits}: leaf counts differ")
        np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-5)
        cut[bits] = {"leaves": leaves,
                     "max_abs_pred_diff": float(np.abs(pa - pb).max()),
                     "sections_equal": tree_sections(a) == tree_sections(b)}
        log(f"phase 18 (b) cut int{bits}: 20,000 rows, card against CPU: "
            f"leaves {leaves} equal, max |d| of predictions "
            f"{cut[bits]['max_abs_pred_diff']:.3e}, tree sections equal "
            f"{cut[bits]['sections_equal']}")
    res["cut"] = cut
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 (b): {res['phase_s']:.1f} s")
    return res


def phase_forced_cegb(torch, lt, ds, params, X, y, rows: int) -> dict:
    """Phase 18 (c): forced splits (`FORCED_HIGGS`) and the CEGB split and
    coupled penalties (`CEGB_HIGGS`), leaf-wise at the HIGGS shape, 5
    rounds: every tree starts with the forced splits in BFS order, the
    holdout AUC above 0.6; then a 20,000-row f64 cut whose card tree
    sections equal the CPU port's, each tree starting with the forced
    splits, each coupled feature paid in no tree after the first that
    uses it."""
    import tempfile
    t_phase = time.perf_counter()
    Xte, yte = X[rows:], y[rows:]
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as fh:
        json.dump(FORCED_HIGGS, fh)
        path = fh.name
    try:
        extra = {"forcedsplits_filename": path, **CEGB_HIGGS}
        fp = {**params, **extra, "tpu_grow_mode": "leafwise"}
        bst, r = train_run(torch, lt, ds, fp, Q_ROUNDS, Xte, yte,
                           "forced + CEGB")
        lr = bst._gbdt.learner
        first = forced_bfs(lr.forced)
        for t in bst.trees:
            if split_nodes(t)[:len(first)] != first:
                raise AssertionError("forced + CEGB: a tree does not start "
                                     "with the forced splits")
        r["forced_nodes"] = len(first)
        r["coupled_used"] = int(lr._cegb_used.sum())
        log(f"phase 18 (c) forced + CEGB: median iteration "
            f"{r['median_iter_ms']:.1f} ms, B1 launches "
            f"{r['launches']['B1']}, holdout AUC {r['auc']:.6f}, every tree "
            f"starts with the {len(first)} forced splits, "
            f"{r['coupled_used']} features paid")
        del bst
        torch.cuda.empty_cache()
        # the 20,000-row f64 cut: card against CPU, the coupled charges
        p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
             "tpu_use_f64_hist": True, "tpu_grow_mode": "leafwise",
             "verbosity": -1, **extra}
        texts, charges = {}, {}
        for dev_t in ("cuda", "cpu"):
            b = lt.Booster({**p, "device_type": dev_t},
                           lt.Dataset(X[:20000], label=y[:20000]))
            lr = b._gbdt.learner
            effs = []
            orig = lr._cegb_coupled_eff

            def record(orig=orig, effs=effs):
                e = orig()
                effs.append(e.copy())
                return e

            lr._cegb_coupled_eff = record
            for _ in range(CUT_ROUNDS):
                b.update()
            texts[dev_t] = tree_sections(b)
            charges[dev_t] = (effs, [t.split_feature_inner[
                :t.num_leaves - 1].tolist() for t in b.trees])
            first_cut = forced_bfs(lr.forced)    # the cut's own bins
            for t in b.trees:
                if split_nodes(t)[:len(first_cut)] != first_cut:
                    raise AssertionError("forced + CEGB cut: a tree does "
                                         "not start with the forced splits")
        if texts["cuda"] != texts["cpu"]:
            raise AssertionError("forced + CEGB f64 cut: card and CPU trees "
                                 "differ")
        effs, feats = charges["cuda"]
        used = set()
        for e, fs in zip(effs, feats):
            paid = {f for f in range(len(e)) if e[f] == 0}
            if paid != used:
                raise AssertionError("CEGB: a coupled feature was charged "
                                     "after the tree that first used it, or "
                                     "not before")
            used |= set(fs)
        log(f"phase 18 (c) f64 cut: 20,000 rows, card and CPU tree sections "
            f"equal, each of {len(effs)} trees charged only the features no "
            f"earlier tree used ({len(used)} used in all)")
        r["cut_features_used"] = len(used)
    finally:
        os.unlink(path)
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 (c): {r['phase_s']:.1f} s")
    return r


def forced_bfs(nodes) -> list:
    """(feature, threshold bin) of the forced nodes in BFS order."""
    first, queue = [], [0] if nodes else []
    while queue:
        f, t, left, right = nodes[queue.pop(0)]
        first.append((f, t))
        queue += [c for c in (left, right) if c >= 0]
    return first


def split_nodes(tree) -> list:
    k = tree.num_leaves - 1
    return list(zip(tree.split_feature_inner[:k].tolist(),
                    tree.threshold_in_bin[:k].tolist()))


def phase_early_stopping(torch, lt, X, y) -> dict:
    """Phase 18 (d): early stopping on a 20,000-row cut with a 10,000-row
    validation set, AUC and logloss, ``early_stopping_rounds`` 3, with and
    without ``first_metric_only`` (f64 histograms, 15 leaves, learning
    rate 0.5, up to 40 rounds): ``best_iteration`` and ``best_score`` on the card
    equal the CPU port's."""
    t_phase = time.perf_counter()
    res = {}
    for fmo in (False, True):
        p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
             "learning_rate": 0.5, "tpu_use_f64_hist": True,
             "tpu_grow_mode": "leafwise", "verbosity": -1,
             "metric": ["auc", "binary_logloss"], "first_metric_only": fmo}
        out = {}
        for dev_t in ("cuda", "cpu"):
            tr = lt.Dataset(X[:20000], label=y[:20000])
            va = tr.create_valid(X[20000:30000], label=y[20000:30000])
            b = lt.train({**p, "device_type": dev_t}, tr,
                         num_boost_round=40, valid_sets=[va],
                         early_stopping_rounds=3, verbose_eval=False)
            out[dev_t] = (b.best_iteration, {
                k: dict(v) for k, v in b.best_score.items()}, b.num_trees())
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"early stopping (first_metric_only={fmo}): "
                                 f"card {out['cuda']} != CPU {out['cpu']}")
        if not 0 < out["cuda"][0] < 40:
            raise AssertionError(f"early stopping did not stop: {out}")
        res[str(fmo)] = {"best_iteration": out["cuda"][0],
                         "best_score": out["cuda"][1],
                         "trees": out["cuda"][2]}
        log(f"phase 18 (d) early stopping, first_metric_only={fmo}: best "
            f"iteration {out['cuda'][0]} of {out['cuda'][2]} trees, best "
            f"score {out['cuda'][1]}, card = CPU")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 (d): {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 20: the rest of the objectives
YEAR_TRAIN, YEAR_TEST, YEAR_FEATURES = 463_715, 51_630, 90
YEAR_ROUNDS = {"host": 3, "auto": 5, "leafwise": 3}
YEAR_HOST = (("regression_l1", {}), ("quantile", {"alpha": 0.9}),
             ("mape", {}))
YEAR_AUTO = ("huber", "fair", "poisson", "gamma", "tweedie")
# the pointwise kinds of B4 and B2's children that ``auto`` takes
KIND_OBJECTIVES = ("huber", "fair", "poisson", "gamma", "tweedie",
                   "xentropy")
XENT_ROUNDS, XENTLAMBDA_ROUNDS, KIND_ROUNDS = 5, 3, 2
OBJ_CUT_ROWS, OBJ_CUT_ROUNDS = 20_000, 2
# every objective this phase's cut holds card against CPU, its parameters
CUT_OBJECTIVES = {
    "regression_l1": {}, "quantile": {"alpha": 0.9}, "mape": {},
    "huber": {}, "fair": {}, "poisson": {}, "gamma": {}, "tweedie": {},
    "xentropy": {}, "xentlambda": {}}
# f32 operations of one row's gradient and hessian by kind, an FMA counted
# as 2 and XLA's exp as 27 (as in OPS_PER_PAIR)
KIND_OPS = {"huber": 5, "fair": 8, "poisson": 2 * 27 + 2,
            "gamma": 27 + 3, "tweedie": 2 * 27 + 10, "xentropy": 27 + 5}


def synth_year(n: int, seed: int = 19):
    """Rows at the shape of UCI YearPredictionMSD (the `year` dataset of
    NVIDIA's gbm-bench): 90 f32 features, 12 timbre means then 78 timbre
    covariances, each at a scale of its own, and a release year from 1922
    to 2011 skewed to the 2000s as the published one is, from a noisy
    nonlinear function of the features."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, YEAR_FEATURES), dtype=np.float32)
    w = rng.standard_normal(YEAR_FEATURES).astype(np.float32) \
        / np.sqrt(YEAR_FEATURES)
    margin = X @ w + 0.4 * np.sin(2.0 * X[:, 0]) * X[:, 1] \
        - 0.3 * (np.abs(X[:, 2]) > 1.0)
    age = np.exp(rng.normal(2.1 + 0.45 * margin, 0.7))
    year = np.clip(2011.0 - np.floor(age), 1922, 2011).astype(np.float32)
    X *= np.concatenate([rng.uniform(5, 50, 12),
                         rng.uniform(20, 2000, 78)]).astype(np.float32)
    return X, year


def holdout_metric(lt, bst, raw, yte) -> tuple:
    """(name, value) of the booster's default metric on holdout labels
    ``yte`` and raw scores ``raw``, through its objective's output."""
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops.metrics import create_metrics
    g = bst._gbdt
    (m,) = create_metrics(g.cfg)
    md = Metadata(len(yte))
    md.set_label(yte)
    m.init(md, len(yte))
    return m.eval(np.asarray(raw, np.float64)[None, :], g.objective)[0]


def year_run(torch, lt, ds, params, rounds, Xte, yte, what) -> tuple:
    """One ``train`` of phase 20 (a) on the card, timed per iteration,
    with every kernel count zeroed just before and read just after: the
    learner and path it took, the aligned engine's layout and fallbacks,
    the median iteration, the default metric on the holdout, and the
    card's predictions against a CPU predict of the model text."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.synchronize()
    H.reset_launches()
    A.reset_launches()
    t_start = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=rounds, callbacks=[stamp],
                   verbose_eval=False)
    launches = {"B1": H.LAUNCHES["f32"] + H.LAUNCHES["f64"], **A.LAUNCHES}
    g = bst._gbdt
    eng = g._aligned_eng
    iters = np.diff([t_start] + stamps)
    raw = bst.predict(Xte, raw_score=True)
    name, value = holdout_metric(lt, bst, raw, yte)
    cpu = lt.Booster(model_str=bst.model_to_string(),
                     params={"device_type": "cpu"})
    sub = Xte[:4000]
    np.testing.assert_allclose(bst.predict(sub, raw_score=True),
                               cpu.predict(sub, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    if not np.all(np.isfinite(raw)) or not np.isfinite(value):
        raise AssertionError(f"{what}: predictions or {name} not finite")
    if bst.num_trees() != rounds:
        raise AssertionError(f"{what}: {bst.num_trees()} trees after "
                             f"{rounds} rounds")
    r = {"learner": type(g.learner).__name__, "train_path": g.train_path,
         "compact": None if eng is None else eng.compact,
         "fallbacks": 0 if eng is None else eng.fallbacks,
         "first_round_s": float(iters[0]),
         "median_iter_ms": statistics.median(iters[1:]) * 1e3,
         "metric": name, "holdout": value, "launches": launches}
    if r["fallbacks"]:
        raise AssertionError(f"{what}: {r['fallbacks']} aligned fallbacks")
    log(f"phase 20 {what}: {r['learner']} ({r['train_path']}"
        + ("" if eng is None else
           f", {'COMPACT' if eng.compact else 'STANDARD'} records")
        + f"), first round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms over {rounds - 1}, holdout {name} "
        f"{value:.6f}, fallbacks {r['fallbacks']}, launches B1 "
        f"{launches['B1']} B2 {launches['move_pass']} B4 "
        f"{launches['slot_hist_pass']}")
    return bst, r


def phase_year(torch, lt) -> dict:
    """Phase 20 (a) and (d): the Year shape's runs (`year_run`) and the
    20,000-row cut card against CPU (`phase_objective_cut`)."""
    t_phase = t0 = time.perf_counter()
    X, y = synth_year(YEAR_TRAIN + YEAR_TEST)
    Xtr, ytr = X[:YEAR_TRAIN], y[:YEAR_TRAIN]
    Xte, yte = X[YEAR_TRAIN:], y[YEAR_TRAIN:]
    log(f"data: {YEAR_TRAIN}+{YEAR_TEST} x {YEAR_FEATURES} synthetic "
        f"YearPredictionMSD rows in {time.perf_counter() - t0:.3f} s")
    params = {"num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbosity": -1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(Xtr, label=ytr, params=params,
                    free_raw_data=False).construct()
    torch.cuda.synchronize()
    res = {"binning_s": time.perf_counter() - t0, "runs": {}}
    log(f"phase 20 (a): binning {res['binning_s']:.3f} s")
    runs = res["runs"]
    for obj, extra in YEAR_HOST:
        bst, r = year_run(torch, lt, ds, {**params, "objective": obj,
                                          **extra}, YEAR_ROUNDS["host"],
                          Xte, yte, f"{obj} (host)")
        if r["learner"] != "SerialTreeLearner" or r["train_path"] != "host" \
                or not r["launches"]["B1"]:
            raise AssertionError(f"phase 20 {obj}: {r['learner']} on "
                                 f"{r['train_path']}, B1 "
                                 f"{r['launches']['B1']}")
        if obj == "regression_l1":
            r["profile"] = profile_round(torch, bst)
        runs[obj] = r
        del bst
    for obj in YEAR_AUTO:
        bst, r = year_run(torch, lt, ds, {**params, "objective": obj},
                          YEAR_ROUNDS["auto"], Xte, yte, f"{obj} auto")
        lc = r["launches"]
        if r["train_path"] != "aligned" or r["compact"] \
                or not lc["move_pass"] or not lc["slot_hist_pass"]:
            raise AssertionError(f"phase 20 {obj} auto: {r['train_path']}, "
                                 f"compact {r['compact']}, launches {lc}")
        runs[f"{obj}_auto"] = r
        del bst
    bst, r = year_run(torch, lt, ds, {**params, "objective": "huber",
                                      "tpu_grow_mode": "leafwise"},
                      YEAR_ROUNDS["leafwise"], Xte, yte, "huber leaf-wise")
    if r["train_path"] != "leafwise" or not r["launches"]["B1"]:
        raise AssertionError("phase 20 huber leaf-wise did not run B1")
    runs["huber_leafwise"] = r
    del bst, ds
    gc.collect()
    torch.cuda.empty_cache()
    res["cut"] = phase_objective_cut(torch, lt, Xtr[:OBJ_CUT_ROWS],
                                     ytr[:OBJ_CUT_ROWS], Xte[:2000])
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20 (a), (d): {res['phase_s']:.1f} s")
    return res


def phase_objective_cut(torch, lt, Xc, yc, Xp) -> dict:
    """Phase 20 (d): every new objective on a 20,000-row cut, f64
    histograms, leaf-wise or on the host learner, on the card and on the
    CPU, OBJ_CUT_ROUNDS each: the tree sections equal and the predictions of
    ``Xp`` equal. The cut is binned once a device and label (the year,
    or the year scaled to [0, 1] for the cross-entropy objectives)."""
    t0 = time.perf_counter()
    base = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.1,
            "min_data_in_leaf": 20, "verbosity": -1,
            "tpu_use_f64_hist": True, "tpu_grow_mode": "leafwise"}
    labels = {"year": yc, "prob": (yc - 1922.0) / 89.0}
    sets = {(dev, name): lt.Dataset(
        Xc, label=lab, params={**base, "device_type": dev}).construct()
        for dev in ("cuda", "cpu") for name, lab in labels.items()}
    out = {}
    for obj, extra in CUT_OBJECTIVES.items():
        label = "prob" if obj.startswith("xent") else "year"
        sect, preds, learners = [], [], []
        for dev in ("cuda", "cpu"):
            bst = lt.train({**base, "objective": obj, **extra,
                            "device_type": dev}, sets[(dev, label)],
                           num_boost_round=OBJ_CUT_ROUNDS,
                           verbose_eval=False)
            sect.append(tree_sections(bst))
            preds.append(bst.predict(Xp))
            learners.append(type(bst._gbdt.learner).__name__)
        host = obj in ("regression_l1", "quantile", "mape")
        if learners != ["SerialTreeLearner" if host
                        else "DeviceTreeLearner"] * 2:
            raise AssertionError(f"phase 20 (d) {obj}: learners {learners}")
        if sect[0] != sect[1]:
            raise AssertionError(f"phase 20 (d) {obj}: the f64 tree "
                                 "sections differ between the card and "
                                 "the CPU")
        if not np.array_equal(preds[0], preds[1]):
            raise AssertionError(f"phase 20 (d) {obj}: predictions differ, "
                                 f"max {np.abs(preds[0] - preds[1]).max()}")
        out[obj] = learners[0]
    r = {"rows": len(yc), "objectives": out,
         "seconds": time.perf_counter() - t0}
    log(f"phase 20 (d): {len(yc)}-row cut, {len(out)} objectives, f64 tree "
        f"sections and predictions equal on the card and the CPU; "
        f"{r['seconds']:.1f} s")
    return r


def check_kind(torch, got, ref, scale, what) -> float:
    """`check_hist`, or `check_hist_nonfinite` where the twin's cells hold
    NaN or Inf (an exp that overflowed); returns the largest finite
    |difference|."""
    if bool(torch.isfinite(ref[..., :2]).all()):
        return check_hist(torch, got, ref, scale, what)
    return check_hist_nonfinite(torch, got, ref, scale, what)["max_abs_err"]


def kind_parity(torch, A, calls, kind) -> dict:
    """Phase 20 (c) on one kind's recorded calls: B4's root pass and the
    widest round's smaller-child histograms (B2's, on the records the
    kernel's partition moved) against the twin, each timed warm and cold
    beside the binary kind on the same records, the twin, one
    ``index_add_`` and the bound (the bytes of the rows' words, score
    and meta lanes, or the kind's f32 operations in both passes and the
    adds, whichever takes longer)."""
    from lightgbm_tpu_torch.ops.objectives import PointGrad
    binary = PointGrad("binary", 1.0, 1.0, 1.0)
    root = calls["slot_hist_pass"]
    rec, slots, meta, k, F, B, wcnt, bits, grad = root
    if grad is None or grad.kind != kind:
        raise AssertionError(f"phase 20 (c) {kind}: the engine passed "
                             f"{grad}")
    move = calls["move_wide"]
    buf = torch.empty_like(move[0])
    nslot, ncnt = A._move_partition_cuda(*move[:9], move[12], move[13], buf)
    _, child_ref = A.move_pass_plain(*move)
    cases = {"root": ((rec, slots, meta, k), A.slot_hist_pass_plain(*root)),
             "children": ((buf, nslot, ncnt, move[8]), child_ref)}
    res = {}
    for case, (head, ref) in cases.items():
        args = (*head, F, B, wcnt, bits, grad)
        as_binary = (*head, F, B, wcnt, bits, binary)
        what = f"{case}, {kind}"
        recs, chunk_slot, chunk_meta, kk = head
        err = check_kind(torch, A._slot_hist_cuda(*args, 2), ref,
                         slot_abs_sums(torch, A, recs, chunk_slot,
                                       chunk_meta, kk, wcnt, grad), what)
        mapped = (chunk_slot >= 0) & (chunk_slot < kk)
        rows = int((chunk_meta & 0xFFFFF)[mapped].sum())
        nc = recs.shape[0]
        r = {"max_abs_err": err, "rows": rows,
             "ms": cuda_ms(torch, lambda a=args: A._slot_hist_cuda(*a, 2)),
             "cold_ms": cold_ms(torch,
                                lambda a=args: A._slot_hist_cuda(*a, 2)),
             "binary_ms": cuda_ms(
                 torch, lambda a=as_binary: A._slot_hist_cuda(*a, 2)),
             "binary_cold_ms": cold_ms(
                 torch, lambda a=as_binary: A._slot_hist_cuda(*a, 2)),
             "plain_ms": cuda_ms(
                 torch, lambda a=args: A.slot_hist_pass_plain(*a), reps=2),
             "library_ms": hist_library_ms(torch, A, recs, chunk_slot,
                                           chunk_meta, kk, F, B, wcnt,
                                           bits, grad, 2)}
        r["bound_ms"], r["bound_by"] = bound(
            rows * (wcnt + 2) * 4 + nc * 2 * 4 + kk * F * B * 3 * 4,
            (2 * KIND_OPS[kind] + 3 * F) * rows)
        log(f"kernel slot_hist {kind} {case}: kernel {r['ms']:.4f} ms warm "
            f"{r['cold_ms']:.4f} cold (binary kind {r['binary_ms']:.4f} / "
            f"{r['binary_cold_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}), {rows} rows, max |d| {err:.3e}")
        res[case] = r
    del buf, nslot, ncnt, cases, child_ref
    return res


def phase_objectives_higgs(torch, lt, ds, params, X, y, rows: int,
                           aligned: dict) -> dict:
    """Phase 20 (b) and (c) on phase 4's data at 63 bins: xentropy and
    xentlambda through ``train``, then each kind's two-round run with its
    second iteration's kernel calls recorded, and `kind_parity` on
    them."""
    from lightgbm_tpu_torch.ops import aligned as A
    t_phase = time.perf_counter()
    Xte, yte = X[rows:], y[rows:]
    res = {"kinds": {}}
    bst, r = train_run(torch, lt, ds, {**params, "objective": "xentropy"},
                       XENT_ROUNDS, Xte, yte, "xentropy auto")
    point = {w: A.POINT_LAUNCHES[(w, "xentropy")]
             for w in ("slot_hist_pass", "move_pass")}
    g = bst._gbdt
    eng = g._aligned_eng
    if g.train_path != "aligned" or not eng.compact or eng.fallbacks \
            or not all(point.values()) \
            or point["move_pass"] != r["launches"]["move_pass"]:
        raise AssertionError(f"phase 20 xentropy auto: {g.train_path}, "
                             f"kind launches {point}, fallbacks "
                             f"{None if eng is None else eng.fallbacks}")
    r.update(point_launches=point, auc_binary=aligned["auc_at_xent"],
             rounds_per_tree=[s[0] for s in g.aligned_stats])
    log(f"phase 20 (b) xentropy auto: median iteration "
        f"{r['median_iter_ms']:.1f} ms, COMPACT, xentropy kind launches "
        f"{point}, holdout AUC {r['auc']:.6f} (binary auto "
        f"{r['auc_binary']:.6f} at {XENT_ROUNDS} rounds)")
    if abs(r["auc"] - r["auc_binary"]) > 2e-3:
        raise AssertionError(f"xentropy AUC {r['auc']} is not within 2e-3 "
                             f"of binary's {r['auc_binary']}")
    res["xentropy"] = r
    del bst, g, eng
    bst, r = train_run(torch, lt, ds, {**params, "objective": "xentlambda"},
                       XENTLAMBDA_ROUNDS, Xte, yte, "xentlambda")
    g = bst._gbdt
    eng = g._aligned_eng
    r.update(train_path=g.train_path,
             ext=None if eng is None else eng.ext,
             fallbacks=0 if eng is None else eng.fallbacks,
             gate=g.aligned_gate())
    if r["fallbacks"]:
        raise AssertionError(f"phase 20 xentlambda: {r['fallbacks']} "
                             "fallbacks")
    log(f"phase 20 (b) xentlambda: {r['train_path']} (EXT {r['ext']}, gate "
        f"{r['gate']}), median iteration {r['median_iter_ms']:.1f} ms, "
        f"holdout AUC {r['auc']:.6f}")
    res["xentlambda"] = r
    del bst, g, eng
    torch.cuda.empty_cache()
    for kind in KIND_OBJECTIVES:
        A.reset_launches()
        calls = capture_kernel_calls(torch, lt, ds,
                                     {**params, "objective": kind},
                                     skip=KIND_ROUNDS - 1)
        launches = {w: A.POINT_LAUNCHES[(w, kind)]
                    for w in ("slot_hist_pass", "move_pass")}
        if not all(launches.values()):
            raise AssertionError(f"phase 20 {kind}: kind launches "
                                 f"{launches}")
        kp = kind_parity(torch, A, calls, kind)
        kp["launches"] = (res["xentropy"]["point_launches"]
                          if kind == "xentropy" else launches)
        res["kinds"][kind] = kp
        del calls
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20 (b), (c): {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 21: uint16 bins (B1's uint16 route), files and the CLI, cv
# ---------------------------------------------------------------------------
U16_ROWS, U16_BINS = 10_485_760, 511
U16_LEAF_ROWS = 20_000
# a feature count and bin count whose f32 cells need bin tiles
U16_TILED_ROWS, U16_TILED_F, U16_TILED_BINS = 200_000, 3, 20_000
U16_ROUNDS = {"leafwise": 3, "quant": 1}
U16_CUT_ROWS, U16_CUT_ROUNDS = 20_000, 2
CLI_ROUNDS, CLI_MORE = 5, 2
CV_FOLDS, CV_ROUNDS, CV_CUT_ROWS = 3, 3, 20_000
PHASE21_DIR = os.path.join("build", "phase21")


def u16_bound_ms(count: int, f: int, bins: int, gh_bytes: int,
                 out_itemsize: int, indexed: bool):
    """Least time for one call of B1's uint16 route: the leaf's uint16
    bins rows (2 B a bin), its (g, h) pairs and its indices read once,
    the output written once, against 3 adds a (row, feature) at the f32
    rate (f64 for an f64 output)."""
    nbytes = count * (2 * f + gh_bytes + (4 if indexed else 0)) \
        + f * bins * 3 * out_itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * f * count / (F64_OPS_PER_S if out_itemsize == 8
                             else F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def u16_check(torch, H, binm, pay, idx, begin, count, bins, prec, what):
    """B1's uint16 route against its twin: f64 and integer payloads
    equal, f32 by `check_hist`; returns the f32 max |difference|."""
    got = H.leaf_histogram(binm, pay, idx, begin, count, bins, prec)
    ref = H.histogram_plain(binm, pay, idx, begin, count, bins, prec)
    torch.cuda.synchronize()
    if prec == "f64" or pay.dtype != torch.float32:
        if not torch.equal(got, ref):
            d = (got - ref).abs().max().item()
            raise AssertionError(f"B1 uint16 {what}, {bins} bins, {prec}: "
                                 f"differs from its twin, max |d| {d}")
        return 0.0
    return check_hist(torch, got[None], ref[None], leaf_abs_sums(
        torch, pay, idx, begin, count), f"B1 uint16 {what}, {bins} bins")


def phase_u16_parity(torch, lt, dev) -> dict:
    """Phase 21 (a): B1's uint16 route against its twin at the HIGGS
    shape binned at max_bin 511 (``synth_higgs``, seed 7, 10,485,760 x
    28, bins on the card by `lt.Dataset`): the contiguous root and a
    gathered leaf of 20,000 rows, f32 (within 1e-5 x the leaf's sum of
    |g|), f64 and int8 / int16 payloads of ``quantize_gh`` (equal); each
    timed warm and cold beside its twin, one ``index_add_`` over a
    prebuilt flat index and its byte bound; then a 200,000 x 3 table of
    20,000 bins, whose cells need the bin-axis tiles, in every
    precision."""
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.bins import take_bins
    from lightgbm_tpu_torch.utils import prng
    t_phase = t0 = time.perf_counter()
    f, n = 28, U16_ROWS
    X, y = synth_higgs(n, f)
    ds = lt.Dataset(X, label=y, params={"max_bin": U16_BINS,
                                        "verbosity": -1}).construct()
    torch.cuda.synchronize()
    binm = ds._handle.bins
    nb = max(m.num_bin for m in ds._handle.used_mappers())
    del X, y, ds
    gc.collect()
    if binm.dtype != torch.uint16 or binm.shape != (n, f) or nb <= 256:
        raise AssertionError(f"phase 21 (a): bins {binm.dtype} "
                             f"{tuple(binm.shape)}, {nb} bins")
    bins = nb
    log(f"phase 21 (a): {n}x{f} HIGGS rows binned at max_bin {U16_BINS} "
        f"on the card in {time.perf_counter() - t0:.3f} s (with the data), "
        f"{bins} bins, uint16")
    gen = torch.Generator(device=dev).manual_seed(21)
    gh = leaf_gh(torch, n, 21, dev)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    pays = {"f32": gh, "f64": gh}
    for bits in (8, 16):
        pays[f"i{bits}"] = H.quantize_gh(gh, bits,
                                         prng.fold_in(prng.key(21), bits))[0]
    res = {"bins": bins, "rows": n, "max_abs_err_f32": 0.0}
    for what, idx, begin, count in (("root", None, 0, n),
                                    ("leaf", perm, n // 16 + 7,
                                     U16_LEAF_ROWS)):
        rows_ = (idx[begin:begin + count].long() if idx is not None
                 else torch.arange(count, device=dev))
        cell = (take_bins(binm, rows_).long() + torch.arange(f, device=dev)
                * bins).reshape(-1)
        for kind, pay in pays.items():
            prec = "f64" if kind == "f64" else "f32"
            err = u16_check(torch, H, binm, pay, idx, begin, count, bins,
                            prec, f"{what} {kind}")
            res["max_abs_err_f32"] = max(res["max_abs_err_f32"], err)

            def kern(pay=pay, prec=prec):
                return H.leaf_histogram(binm, pay, idx, begin, count, bins,
                                        prec)
            dtype = {"f32": torch.float32, "f64": torch.float64}.get(
                kind, torch.int64)
            p = torch.cat([pay[rows_].to(dtype), torch.ones(
                (count, 1), dtype=dtype, device=dev)], 1)
            p = p[:, None, :].expand(-1, f, -1).reshape(-1, 3)
            acc = torch.zeros((f * bins, 3), dtype=dtype, device=dev)
            gh_bytes = 8 if kind in ("f32", "f64") else 2 * int(kind[1:]) // 8
            b_ms, b_by = u16_bound_ms(count, f, bins, gh_bytes,
                                      8 if kind == "f64" else 4,
                                      idx is not None)
            r = {"rows": count, "max_abs_err": err,
                 "ms": cuda_ms(torch, kern, reps=10),
                 "cold_ms": cold_ms(torch, kern),
                 "plain_ms": cuda_ms(torch, lambda pay=pay, prec=prec:
                                     H.histogram_plain(binm, pay, idx, begin,
                                                       count, bins, prec),
                                     reps=2),
                 "library_ms": cuda_ms(torch, lambda: acc.index_add_(
                     0, cell, p), reps=2),
                 "bound_ms": b_ms, "bound_by": b_by}
            del p, acc
            res[f"{what} {kind}"] = r
            log(f"kernel B1 uint16 {what} {count}x{f}, {bins} bins, {kind}: "
                f"{'equal to' if err == 0.0 else 'within 1e-5 of'} the "
                f"twin, warm {r['ms']:.4f} ms, cold {r['cold_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, index_add_ "
                f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del cell, rows_
    del binm, gh, perm, pays
    torch.cuda.empty_cache()
    # the bin-axis tiles
    tn, tf, tb = U16_TILED_ROWS, U16_TILED_F, U16_TILED_BINS
    tbins = torch.randint(0, tb, (tn, tf), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16).view(
                              torch.uint16)
    tgh = leaf_gh(torch, tn, 22, dev)
    tperm = torch.randperm(tn, generator=gen, device=dev).to(torch.int32)
    num_sms, optin = H._device(dev.index or 0)
    shape = H.launch_shape16(tn, tf, tb, "f32", num_sms, optin)
    if shape[1] >= tb:
        raise AssertionError(f"phase 21 (a): {tb} bins took no bin tiles "
                             f"({shape})")
    q8 = H.quantize_gh(tgh, 8, prng.key(3))[0]
    for what, idx, begin, count in (("root", None, 0, tn),
                                    ("leaf", tperm, 11, tn // 3)):
        for kind, pay, prec in (("f32", tgh, "f32"), ("f64", tgh, "f64"),
                                ("i8", q8, "f32")):
            res["max_abs_err_f32"] = max(
                res["max_abs_err_f32"],
                u16_check(torch, H, tbins, pay, idx, begin, count, tb,
                          prec, f"tiled {what} {kind}"))
    res["tiled"] = {"rows": tn, "features": tf, "bins": tb,
                    "bins_per_tile": shape[1]}
    log(f"phase 21 (a): {tn}x{tf} at {tb} bins in tiles of {shape[1]} bins "
        f"(f32), f32, f64 and int8 against the twin; max f32 |d| "
        f"{res['max_abs_err_f32']:.3e}")
    del tbins, tgh, tperm, q8
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21 (a): {res['phase_s']:.1f} s")
    return res


def phase_u16_airline(torch, lt, rows: int, holdout: int) -> dict:
    """Phase 21 (b): the airline table uncut (`synth_airline`, Zipf s 1.1
    for Origin and Dest, whose ~273 bins make the matrix uint16; 10M +
    500k x 8, the six code columns categorical, 255 leaves and bins):
    ``auto`` must log the leaf-wise path with the reason "bins not
    uint8", 3 rounds, every B1 launch on the uint16 route; one profiled
    round; ``tpu_quant_hist=on`` at 8 and 16 bits, 2 rounds each (B1's
    uint16 integer kernels); then a 20,000-row cut, still uint16, f64
    leaf-wise on the card and on the CPU: tree sections and predictions
    equal."""
    from lightgbm_tpu_torch.ops import histogram as H
    t_phase = t0 = time.perf_counter()
    X, y = synth_airline(rows + holdout, zipf=1.1)
    Xtr, ytr, Xte, yte = X[:rows], y[:rows], X[rows:], y[rows:]
    log(f"data: {rows}+{holdout} x 8 airline rows at Zipf s 1.1 in "
        f"{time.perf_counter() - t0:.3f} s")
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(Xtr, label=ytr, params=params,
                    categorical_feature=AIRLINE_CATS,
                    free_raw_data=False).construct()
    torch.cuda.synchronize()
    res = {"binning_s": time.perf_counter() - t0,
           "num_bin": [m.num_bin for m in ds._handle.used_mappers()]}
    if ds._handle.bins.dtype != torch.uint16:
        raise AssertionError(f"phase 21 (b): bins {ds._handle.bins.dtype}, "
                             f"bins per column {res['num_bin']}")
    log(f"phase 21 (b): binning {res['binning_s']:.3f} s, bins per column "
        f"{res['num_bin']}, uint16 matrix")
    bst, a = airline_run(torch, lt, ds, params, U16_ROUNDS["leafwise"],
                         Xte, yte, "auto, uint16 bins")
    why = "training path: leafwise (aligned engine rejected: bins not uint8)"
    if a["train_path"] != "leafwise" \
            or not any(why in ln for ln in a["path_log"]):
        raise AssertionError(f"phase 21 (b): {a['train_path']}, log "
                             f"{a['path_log']}")
    if a["launches"]["B1"] or not a["launches"]["B1_u16_f32"]:
        raise AssertionError(f"phase 21 (b): B1 launches {a['launches']}")
    if not any(a["cat_nodes_per_tree"]):
        raise AssertionError("phase 21 (b): no categorical node")
    a["profile"] = profile_round(torch, bst)
    a["profile_b1_launches"] = sum(
        k["launches"] for k in a["profile"]["hist_kernels"].values())
    del bst
    res["leafwise"] = a
    for bits in (8, 16):
        bst, q = airline_run(torch, lt, ds, {
            **params, "tpu_grow_mode": "leafwise", "tpu_quant_hist": "on",
            "tpu_quant_hist_bits": bits}, U16_ROUNDS["quant"], Xte, yte,
            f"quantized int{bits}, uint16 bins")
        if not q["launches"][f"B1_u16_i{bits}"] \
                or q["launches"]["B1_u16_f32"]:
            raise AssertionError(f"phase 21 (b) int{bits}: launches "
                                 f"{q['launches']}")
        res[f"quant{bits}"] = q
        del bst
    del ds
    gc.collect()
    torch.cuda.empty_cache()
    # the f64 cut, card against CPU
    base = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
            "tpu_use_f64_hist": True, "tpu_grow_mode": "leafwise"}
    H.reset_launches()
    sect, preds = [], []
    for dev_type in ("cuda", "cpu"):
        p = {**base, "device_type": dev_type}
        cds = lt.Dataset(Xtr[:U16_CUT_ROWS], label=ytr[:U16_CUT_ROWS],
                         params=p, categorical_feature=AIRLINE_CATS)
        bst = lt.train(p, cds, num_boost_round=U16_CUT_ROUNDS,
                       verbose_eval=False)
        if bst._gbdt.train_data.bins.dtype != torch.uint16:
            raise AssertionError("phase 21 (b): the cut's bins are not "
                                 "uint16")
        sect.append(tree_sections(bst))
        preds.append(bst.predict(Xte[:2000]))
        if dev_type == "cuda":
            res["cut_f64_launches"] = H.WIDE_LAUNCHES["f64"]
    if sect[0] != sect[1] or not np.array_equal(preds[0], preds[1]):
        raise AssertionError("phase 21 (b): the uint16 cut's f64 trees or "
                             "predictions differ between the card and the "
                             "CPU")
    if not res["cut_f64_launches"]:
        raise AssertionError("phase 21 (b): the f64 cut never ran B1's "
                             "uint16 f64 kernel")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21 (b): the {U16_CUT_ROWS}-row uint16 cut's f64 tree "
        f"sections and predictions equal on the card and the CPU; "
        f"{res['phase_s']:.1f} s")
    return res


def _write_part(args) -> str:
    path, block = args
    np.savetxt(path, block, delimiter=",", fmt="%.9g")
    return path


def write_csv(path: str, y, X, header) -> None:
    """label first, then the features, ``%.9g`` (f32 values read back
    exactly), a header line unless ``header`` is None; formatted by 8 spawned worker processes a
    block of rows each, then joined."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    M = np.concatenate([y[:, None].astype(np.float64),
                        X.astype(np.float64)], axis=1)
    blocks = np.array_split(M, 8)
    parts = [(f"{path}.part{i}", b) for i, b in enumerate(blocks)]
    with ProcessPoolExecutor(
            8, mp_context=multiprocessing.get_context("spawn")) as pool:
        names = list(pool.map(_write_part, parts))
    with open(path, "w") as out:
        if header is not None:
            out.write(",".join(header) + "\n")
        for name in names:
            with open(name) as fh:
                while True:
                    chunk = fh.read(1 << 24)
                    if not chunk:
                        break
                    out.write(chunk)
            os.remove(name)


def run_cli(args, cwd, what, phase="phase 21 (c)") -> str:
    """``python -m lightgbm_tpu_torch`` in a process of its own, the
    checkout on its path; returns its standard output, fails the run on a
    non-zero exit."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{phase} {what}: exit "
                             f"{proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    log(f"{phase} {what}: {time.perf_counter() - t0:.1f} s, "
        f"{proc.stdout.strip().splitlines()[-1]}")
    return proc.stdout


def model_trees(text: str) -> list:
    """The tree blocks of a model text without their ``Tree=i`` lines."""
    body = text[text.index("Tree=0"):text.index("end of trees")]
    return [blk.split("\n", 1)[1] for blk in body.split("Tree=")[1:]]


def phase_files(torch, lt) -> dict:
    """Phase 21 (c) and (d): the Year shape (`synth_year`, seed 19,
    463,715 + 51,630 x 90, uncut) written as CSV files with a header
    (the write timed apart), then ``python -m lightgbm_tpu_torch`` in
    four runs: ``task=train`` (l2, 255 leaves and bins, 5 rounds,
    ``valid=`` the test file, ``save_binary``), ``task=predict`` on the
    test file (its output equal to the in-process `Booster.predict`'s),
    a second train from the ``.bin`` (the model text equal to the
    first's up to the params), ``input_model=`` for 2 more rounds (the
    first 5 trees the input model's); ``task=convert_model``, the C++
    compiled with the host compiler, whose raw scores of 1,000 test rows
    are the model's within 1e-12; parse, binning and binary-load s and
    the median iteration in this process. (d) `cv`, 3 folds and 3 rounds
    on the card; on a 20,000-row cut, f64 leaf-wise, the card's result
    dict equal to the CPU's."""
    import shutil
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
    from lightgbm_tpu_torch.io.loader import DatasetLoader
    t_phase = t0 = time.perf_counter()
    X, y = synth_year(YEAR_TRAIN + YEAR_TEST)
    Xtr, ytr = X[:YEAR_TRAIN], y[:YEAR_TRAIN]
    Xte, yte = X[YEAR_TRAIN:], y[YEAR_TRAIN:]
    work = os.path.abspath(PHASE21_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    header = ["year"] + [f"f{j}" for j in range(YEAR_FEATURES)]
    t0 = time.perf_counter()
    write_csv(os.path.join(work, "train.csv"), ytr, Xtr, header)
    write_csv(os.path.join(work, "test.csv"), yte, Xte, header)
    res = {"write_s": time.perf_counter() - t0,
           "csv_bytes": os.path.getsize(os.path.join(work, "train.csv"))}
    log(f"phase 21 (c): CSV files written in {res['write_s']:.1f} s "
        f"({res['csv_bytes'] / 2**20:.1f} MiB of training rows)")
    common = ["task=train", "objective=regression", "header=true",
              "num_leaves=255", "max_bin=255", "learning_rate=0.1",
              "min_data_in_leaf=20", "verbosity=-1"]
    run_cli(common + ["data=train.csv", "valid=test.csv",
                      f"num_trees={CLI_ROUNDS}", "save_binary=true",
                      "metric=l2", "output_model=m1.txt"], work, "train")
    first = open(os.path.join(work, "m1.txt")).read()
    run_cli(["task=predict", "data=test.csv", "header=true",
             "input_model=m1.txt", "output_result=pred.txt"], work,
            "predict")
    bst = lt.Booster(model_file=os.path.join(work, "m1.txt"))
    mine = bst.predict(Xte.astype(np.float64))
    got = open(os.path.join(work, "pred.txt")).read().split()
    if got != [f"{v:g}" for v in mine]:
        raise AssertionError("phase 21 (c): task=predict's output differs "
                             "from Booster.predict's")
    run_cli(common + ["data=train.csv.bin", f"num_trees={CLI_ROUNDS}",
                      "output_model=m_bin.txt"], work, "train from .bin")
    again = open(os.path.join(work, "m_bin.txt")).read()
    if again[:again.index("end of trees")] \
            != first[:first.index("end of trees")]:
        raise AssertionError("phase 21 (c): the run from the .bin wrote "
                             "another model")
    run_cli(common + ["data=train.csv", "input_model=m1.txt",
                      f"num_trees={CLI_MORE}", "output_model=m2.txt"], work,
            "input_model")
    cont = open(os.path.join(work, "m2.txt")).read()
    if model_trees(cont)[:CLI_ROUNDS] != model_trees(first) \
            or len(model_trees(cont)) != CLI_ROUNDS + CLI_MORE:
        raise AssertionError("phase 21 (c): the continued model does not "
                             "start with the input model's trees")
    res["convert"] = check_convert(torch, lt, work, Xte)
    # the stages in this process
    cfg = Config.from_params({"header": True, "max_bin": 255,
                              "verbosity": -1})
    t0 = time.perf_counter()
    labels, feats, _ = DatasetLoader(cfg).parse_file(
        os.path.join(work, "train.csv"))
    res["parse_s"] = time.perf_counter() - t0
    if not np.array_equal(feats.astype(np.float32), Xtr):
        raise AssertionError("phase 21 (c): the parsed rows are not the "
                             "written ones")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core = CoreDataset.from_matrix(feats, label=labels, config=cfg,
                                   device=torch.device(DEVICE))
    torch.cuda.synchronize()
    res["binning_s"] = time.perf_counter() - t0
    del feats, core
    t0 = time.perf_counter()
    loaded = lt.Dataset(os.path.join(work, "train.csv.bin"),
                        params={"verbosity": -1}).construct()
    torch.cuda.synchronize()
    res["binary_load_s"] = time.perf_counter() - t0
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    t0 = time.perf_counter()
    lt.train({"objective": "regression", "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}, loaded, num_boost_round=CLI_ROUNDS,
             callbacks=[stamp], verbose_eval=False)
    res["median_iter_ms"] = statistics.median(
        np.diff([t0] + stamps)[1:]) * 1e3
    log(f"phase 21 (c): parse {res['parse_s']:.3f} s, binning "
        f"{res['binning_s']:.3f} s, binary load {res['binary_load_s']:.3f} "
        f"s, median iteration {res['median_iter_ms']:.1f} ms (the .bin "
        f"dataset, auto)")
    del loaded
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["cv"] = phase_cv(torch, lt, Xtr, ytr)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 21 (c), (d): {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 22: ingest
PHASE22_DIR = os.path.join("build", "phase22")
STREAM_FILE_CHUNK, STREAM_MATRIX_CHUNK = 65_536, 1 << 20
INGEST_ROUNDS, ES_BINARY_ROUNDS, ES_MC_ROUNDS, ES_ROWS = 3, 40, 10, 100_000
ES = {"pred_early_stop": True, "pred_early_stop_freq": 2,
      "pred_early_stop_margin": 1.0}


def check_native(lt) -> str:
    """The native library builds from ``src/native/`` into
    ``build/torch_native/``; returns its path."""
    from lightgbm_tpu_torch import native
    root = os.path.dirname(os.path.abspath(__file__))
    if not native.native_available():
        raise AssertionError("phase 22: the native library did not build")
    path = native.built_path()
    if os.path.dirname(path) != os.path.join(root, "build", "torch_native") \
            or not os.path.isfile(path) or native.SRC_DIR != os.path.join(
                root, "src", "native"):
        raise AssertionError(f"phase 22: the native library is {path}")
    omp = path == native.library_path(native.CXX_FLAGS)
    log(f"phase 22: native library {os.path.relpath(path, root)} from "
        f"src/native ({', '.join(native.SOURCES)}), "
        f"{'with' if omp else 'WITHOUT'} OpenMP (the compilers tried: "
        f"{native._compilers()})")
    return path


def timed(torch, fn):
    """(result, seconds) of ``fn()``, the card synchronized after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trees_text(bst) -> str:
    text = bst.model_to_string()
    return text[text.index("Tree=0"):text.index("end of trees")]


def device_busy_ms(torch, prof) -> float:
    """The card's busy ms in a profiled window: its kernels and copies,
    summed over the profiler's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() / 1e6
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


class PrefetchChunks:
    """The JAX package's ``ChunkPrefetcher`` at depth 2, for the A/B of
    ``--prefetch-ab`` only: a thread makes chunk k + 1, and reads its rows
    into memory, while the consumer bins chunk k."""

    _DONE = object()

    def __init__(self, chunks) -> None:
        import queue
        import threading
        self._gen, self._exc = iter(chunks), None
        self._q = queue.Queue(maxsize=1)
        self._t = threading.Thread(target=self._produce, daemon=True)
        self._t.start()

    def _produce(self) -> None:
        try:
            for feats, labs, w in self._gen:
                self._q.put((np.ascontiguousarray(feats), labs, w))
        except BaseException as e:      # raised on the consumer's side
            self._exc = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                self._t.join()
                if self._exc is not None:
                    raise self._exc
                return
            yield item


def prefetch_ab(torch, make, runs: int, tag: str) -> dict:
    """``runs`` loads by ``make()`` with the port's one thread and
    ``runs`` with `PrefetchChunks` patched into `io.stream.run_pipeline`,
    alternating (ABBA ...): each load's seconds and its stage ms."""
    from lightgbm_tpu_torch.io import stream
    plain = stream.run_pipeline
    out = {"one_thread": [], "prefetch": []}
    for r in range(runs):
        order = ("one_thread", "prefetch") if r % 2 == 0 else (
            "prefetch", "one_thread")
        for name in order:
            if name == "prefetch":
                stream.run_pipeline = lambda ds, chunks: plain(
                    ds, PrefetchChunks(chunks))
            try:
                d, sec = timed(torch, make)
            finally:
                stream.run_pipeline = plain
            st = d._handle._ingest_stats
            out[name].append({"s": sec, "parse_ms": st["parse_ms"],
                              "bin_ms": st["bin_ms"]})
            del d
            gc.collect()
    for name in ("one_thread", "prefetch"):
        out[f"{name}_median_s"] = float(np.median([v["s"]
                                                   for v in out[name]]))
    stages = [(round(v["parse_ms"]), round(v["bin_ms"]))
              for v in out["one_thread"]]
    log(f"{tag} prefetch A/B, {runs} loads each: one thread "
        f"{[round(v['s'], 3) for v in out['one_thread']]} s (median "
        f"{out['one_thread_median_s']:.3f}), prefetch thread "
        f"{[round(v['s'], 3) for v in out['prefetch']]} s (median "
        f"{out['prefetch_median_s']:.3f}); one thread's parse / bin ms "
        f"{stages}")
    return out


def phase_stream_higgs(torch, lt, X, y, rows: int, ab: int = 0) -> dict:
    """Phase 22 (b): phase 4's HIGGS matrix saved as a float32 memmap,
    then `stream_matrix` over it (chunks of 1,048,576 rows) under
    `torch.profiler` against `from_matrix` on the card: equal bins, 3
    leaf-wise rounds from each with equal trees; both ingests' seconds
    and the card's idle share during the streamed one."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    work = os.path.abspath(PHASE22_DIR)
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "higgs.f32")
    mm = np.memmap(path, np.float32, "w+", shape=(rows, X.shape[1]))
    mm[:] = X[:rows]
    mm.flush()
    del mm
    mm = np.memmap(path, np.float32, "r", shape=(rows, X.shape[1]))
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "tpu_grow_mode": "leafwise",
              "verbosity": -1}
    one, one_s = timed(torch, lambda: lt.Dataset(
        X[:rows], label=y[:rows], params=params).construct())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, st_s = timed(torch, lambda: lt.Dataset(
            mm, label=y[:rows], params={
                **params, "tpu_stream_chunk_rows": STREAM_MATRIX_CHUNK}
        ).construct())
    busy_ms = device_busy_ms(torch, prof)
    if not torch.equal(st._handle.bins, one._handle.bins):
        raise AssertionError("phase 22 (b): stream_matrix's bins differ from "
                             "from_matrix's")
    texts = []
    for ds in (one, st):
        bst = lt.train(params, ds, num_boost_round=INGEST_ROUNDS,
                       verbose_eval=False)
        texts.append(trees_text(bst))
        del bst
    if texts[0] != texts[1]:
        raise AssertionError("phase 22 (b): the streamed dataset trained "
                             "other trees")
    del one
    if ab:
        ab = prefetch_ab(torch, lambda: lt.Dataset(
            mm, label=y[:rows], params={
                **params, "tpu_stream_chunk_rows": STREAM_MATRIX_CHUNK}
        ).construct(), ab, "phase 22 (b)")
    r = {"rows": rows, "from_matrix_s": one_s, "stream_s": st_s,
         "stream_stats": st._handle._ingest_stats, "busy_ms": busy_ms,
         "idle_share": 1 - busy_ms / (st_s * 1e3),
         "memmap_bytes": os.path.getsize(path), "prefetch_ab": ab or None}
    del st, mm
    os.remove(path)
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 22 (b): HIGGS {rows}x{X.shape[1]} from a "
        f"{r['memmap_bytes'] / 2**30:.2f} GiB float32 memmap: stream_matrix "
        f"{st_s:.3f} s (chunks of {STREAM_MATRIX_CHUNK}; stages "
        f"{ {k: round(v, 1) for k, v in r['stream_stats'].items()} }), "
        f"card busy {busy_ms:.1f} ms, idle {100 * r['idle_share']:.1f}%; "
        f"from_matrix {one_s:.3f} s; bins equal, {INGEST_ROUNDS} leaf-wise "
        f"rounds from each with equal trees; {r['phase_s']:.1f} s")
    return r


def phase_ingest(torch, lt, ab: int = 0) -> dict:
    """Phase 22 (a), (c), (d), (e) on the Year shape's CSV files without
    a header (see the module docstring)."""
    import shutil
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.cli import _wrap_core
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import stream
    from lightgbm_tpu_torch.io.loader import DatasetLoader
    from lightgbm_tpu_torch.io.parser import create_parser, parse_dense
    t_phase = time.perf_counter()
    X, y = synth_year(YEAR_TRAIN + YEAR_TEST)
    Xtr, ytr = X[:YEAR_TRAIN], y[:YEAR_TRAIN]
    work = os.path.abspath(PHASE22_DIR)
    os.makedirs(work, exist_ok=True)
    train, test = (os.path.join(work, f) for f in ("train.csv", "test.csv"))
    res = {}
    (_, res["write_s"]) = timed(torch, lambda: (
        write_csv(train, ytr, Xtr, None),
        write_csv(test, y[YEAR_TRAIN:], X[YEAR_TRAIN:], None)))
    # (a) the native parse against the numpy parse
    (lab, feats, fmt), res["native_parse_s"] = timed(
        torch, lambda: native.parse_file(train, 0))

    def numpy_parse():
        with open(train) as fh:
            lines = fh.read().splitlines()
        return parse_dense(lines, create_parser(lines[:32], 0))
    (plab, pfeats), res["numpy_parse_s"] = timed(torch, numpy_parse)
    if not (np.array_equal(lab, plab) and np.array_equal(
            feats, pfeats, equal_nan=True)
            and np.array_equal(feats.astype(np.float32), Xtr)):
        raise AssertionError("phase 22 (a): the native parse differs from "
                             "the numpy parse")
    del pfeats, plab
    log(f"phase 22 (a): CSV files written in {res['write_s']:.1f} s; "
        f"parse of {os.path.getsize(train) / 2**20:.1f} MiB ({fmt}): "
        f"native {res['native_parse_s']:.3f} s, numpy "
        f"{res['numpy_parse_s']:.3f} s, equal")
    base = {"objective": "regression", "num_leaves": 255, "max_bin": 255,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}
    loads = {"one-shot": {}, "two-round": {"two_round": True},
             "streamed": {"tpu_stream_chunk_rows": STREAM_FILE_CHUNK}}
    ds = {}
    for name, extra in loads.items():
        ds[name], res[f"{name}_load_s"] = timed(torch, lambda: lt.Dataset(
            train, params={**base, **extra}).construct())
    cpu_two, res["two-round_cpu_load_s"] = timed(torch, lambda: lt.Dataset(
        train, params={**base, "two_round": True,
                       "device_type": "cpu"}).construct())
    if not torch.equal(ds["two-round"]._handle.bins.cpu(),
                       cpu_two._handle.bins):
        raise AssertionError("phase 22 (a): the two-round bins on the card "
                             "differ from the CPU's")
    del cpu_two
    if not torch.equal(ds["streamed"]._handle.bins,
                       ds["one-shot"]._handle.bins):
        raise AssertionError("phase 22 (a): the streamed bins differ from "
                             "the one-shot load's")
    res["stream_stats"] = ds["streamed"]._handle._ingest_stats
    if ab:
        res["prefetch_ab"] = prefetch_ab(torch, lambda: lt.Dataset(
            train, params={**base, **loads["streamed"]}).construct(), ab,
            "phase 22 (a)")
    texts = {}
    for name, d in ds.items():
        bst = lt.train(base, d, num_boost_round=INGEST_ROUNDS,
                       verbose_eval=False)
        texts[name] = trees_text(bst)
        res[f"{name}_path"] = bst._gbdt.train_path
        if name == "one-shot":
            bst.save_model(os.path.join(work, "m1.txt"))
        del bst
    if texts["streamed"] != texts["one-shot"]:
        raise AssertionError("phase 22 (a): the streamed run's trees differ "
                             "from the one-shot run's")
    log("phase 22 (a): loads " + ", ".join(
        f"{n} {res[f'{n}_load_s']:.3f} s" for n in loads)
        + f", two-round on the CPU {res['two-round_cpu_load_s']:.3f} s; "
        f"two-round bins card = CPU, streamed bins = one-shot's; "
        f"{INGEST_ROUNDS} rounds of auto from each ({res['one-shot_path']}), "
        f"the streamed trees the one-shot ones; streamed stages "
        f"{ {k: round(v, 1) for k, v in res['stream_stats'].items()} }")
    stream_bins = ds["streamed"]._handle.bins
    del ds
    # (c) C.35: input_model with valid= through the CLI
    args = [f"{k}={v}" for k, v in base.items()] + [
        "task=train", "data=train.csv", "valid=test.csv", "metric=l2",
        "input_model=m1.txt", f"num_trees={CLI_MORE}",
        "output_model=m2.txt"]
    out = run_cli(args, work, "input_model with valid=", "phase 22 (c)")
    printed = [ln for ln in out.splitlines() if ln.startswith("[")]
    prior = lt.Booster(model_file=os.path.join(work, "m1.txt"))
    cfg = Config.from_params({**base, "metric": "l2"})
    loader = DatasetLoader(cfg, predict_fun=lambda A: prior.predict(
        A, raw_score=True))
    core = loader.load_from_file(train)
    vcore = loader.load_from_file_align_with_other_dataset(test, core)
    ev = {}
    lt.train({**base, "metric": "l2"}, _wrap_core(core, base),
             num_boost_round=CLI_MORE, init_model=os.path.join(work,
                                                               "m1.txt"),
             valid_sets=[_wrap_core(vcore, base)], valid_names=["test.csv"],
             evals_result=ev, verbose_eval=False)
    want = [f"[{i + 1}]\ttest.csv's l2: {v:g}"
            for i, v in enumerate(ev["test.csv"]["l2"])]
    if printed != want:
        raise AssertionError(f"phase 22 (c): the CLI printed {printed}, the "
                             f"in-process run {want}")
    res["cli_valid_l2"] = ev["test.csv"]["l2"]
    log(f"phase 22 (c): task=train input_model= valid=: exit 0, "
        f"{printed} equal to the in-process run")
    del core, vcore, prior
    # (d) C.36: prediction early stopping on the card against the CPU
    Xte = X[YEAR_TRAIN:].astype(np.float64)
    res["early_stop"] = {}
    for kind, params, rounds, label in (
            ("binary", {"objective": "binary"}, ES_BINARY_ROUNDS,
             (ytr[:ES_ROWS] > np.median(ytr)).astype(np.float64)),
            ("multiclass", {"objective": "multiclass", "num_class": 3},
             ES_MC_ROUNDS, np.digitize(ytr[:ES_ROWS], np.quantile(
                 ytr, [1 / 3, 2 / 3])).astype(np.float64))):
        p = {**params, "num_leaves": 63, "learning_rate": 0.5,
             "verbosity": -1}
        bst = lt.train(p, lt.Dataset(Xtr[:ES_ROWS], label=label, params=p),
                       num_boost_round=rounds, verbose_eval=False)
        card, card_s = timed(torch, lambda: bst.predict(Xte, **ES))
        cpu = lt.Booster(model_str=bst.model_to_string(),
                         params={"device_type": "cpu"})
        host, host_s = timed(torch, lambda: cpu.predict(Xte, **ES))
        full = bst.predict(Xte)
        moved = int(np.sum(np.any((card != full).reshape(len(Xte), -1),
                                  axis=1)))
        if not np.array_equal(card, host) or moved == 0:
            raise AssertionError(f"phase 22 (d) {kind}: the card's early-"
                                 f"stopped scores equal the CPU's: "
                                 f"{np.array_equal(card, host)}, rows moved "
                                 f"from the full scores {moved}")
        res["early_stop"][kind] = {"rows_moved": moved, "card_s": card_s,
                                   "cpu_s": host_s, "max_move": float(
                                       np.abs(card - full).max())}
        log(f"phase 22 (d) {kind}: pred_early_stop on the card equal to the "
            f"CPU's native predictor ({card_s:.3f} / {host_s:.3f} s), "
            f"{moved} of {len(Xte)} rows moved from the full scores, by up "
            f"to {res['early_stop'][kind]['max_move']:.4f}")
        del bst, cpu
    # (e) the columnar load
    if stream.pyarrow_available():
        import pyarrow as pa
        import pyarrow.parquet as pq
        # the parsed f64 values: the CSV's decimals, not the f32 ones
        pq_path = os.path.join(work, "train.parquet")
        cols = {"label": lab}
        cols.update({f"f{j}": feats[:, j] for j in range(feats.shape[1])})
        pq.write_table(pa.table(cols), pq_path)
        del cols
        col, res["columnar_load_s"] = timed(torch, lambda: lt.Dataset(
            pq_path, params={**base, "tpu_stream_chunk_rows":
                             STREAM_FILE_CHUNK}).construct())
        if not torch.equal(col._handle.bins, stream_bins):
            raise AssertionError("phase 22 (e): the Parquet load's bins "
                                 "differ from the streamed CSV load's")
        log(f"phase 22 (e): Parquet load {res['columnar_load_s']:.3f} s, "
            "bins equal to the streamed CSV load's")
        del col
    else:
        res["columnar_load_s"] = None
        log("phase 22 (e): not run: pyarrow does not import on this "
            "machine")
    del stream_bins, lab, feats
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 22 (a), (c)-(e): {res['phase_s']:.1f} s")
    return res


def check_convert(torch, lt, work, Xte) -> dict:
    """``task=convert_model`` of the continued model (in this process,
    through the CLI's `main`), the C++ compiled with the host compiler
    and run on 1,000 test rows: its raw scores within 1e-12 of the
    model's."""
    import shutil
    from lightgbm_tpu_torch import cli
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        if cli.main(["task=convert_model", "input_model=m2.txt",
                     "convert_model=pred.cpp"]) != 0:
            raise AssertionError("phase 21 (c): convert_model failed")
    finally:
        os.chdir(cwd)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise AssertionError("phase 21 (c): no host C++ compiler")
    rows = Xte[:1000].astype(np.float64)
    np.savetxt(os.path.join(work, "rows.txt"), rows, fmt="%.17g")
    code = open(os.path.join(work, "pred.cpp")).read() + r'''
#include <cstdio>
#include <cstdlib>
int main() {
  static double row[%d];
  FILE* f = std::fopen("rows.txt", "r");
  for (;;) {
    for (int j = 0; j < %d; ++j) {
      if (std::fscanf(f, "%%lf", &row[j]) != 1) return 0;
    }
    std::printf("%%.17g\n", PredictRaw(row, 0));
  }
}
''' % (rows.shape[1], rows.shape[1])
    with open(os.path.join(work, "main.cpp"), "w") as fh:
        fh.write(code)
    subprocess.run([cxx, "-O1", "-o", os.path.join(work, "pred"),
                    os.path.join(work, "main.cpp")], check=True,
                   capture_output=True, text=True)
    out = subprocess.run([os.path.join(work, "pred")], cwd=work, check=True,
                         capture_output=True, text=True).stdout.split()
    got = np.array([float(v) for v in out])
    ref = lt.Booster(model_file=os.path.join(work, "m2.txt")).predict(
        rows, raw_score=True)
    d = float(np.abs(got - ref).max()) if len(got) == len(ref) else None
    if d is None or d > 1e-12:
        raise AssertionError(f"phase 21 (c): the compiled C++ scores differ "
                             f"from the model's ({d})")
    r = {"rows": len(got), "max_abs_diff": d,
         "seconds": time.perf_counter() - t0}
    log(f"phase 21 (c): convert_model's C++ on {len(got)} rows, max |d| "
        f"{d:.3e} against the model's raw scores; {r['seconds']:.1f} s")
    return r


def phase_cv(torch, lt, Xtr, ytr) -> dict:
    """Phase 21 (d): `cv` on the Year table, 3 folds and 3 rounds on the
    card under ``auto`` (255 leaves and bins), timed; then a 20,000-row
    cut, f64 leaf-wise (15 leaves, 63 bins), the card's result dict equal
    to the CPU's."""
    t0 = time.perf_counter()
    params = {"objective": "regression", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "metric": ["l2", "l1"]}
    res = lt.cv(params, lt.Dataset(Xtr, label=ytr, params=params),
                num_boost_round=CV_ROUNDS, nfold=CV_FOLDS, seed=21,
                return_cvbooster=True)
    cvb = res.pop("cvbooster")
    paths = [b._gbdt.train_path for b in cvb.boosters]
    out = {"seconds": time.perf_counter() - t0, "paths": paths,
           "result": {k: v for k, v in res.items()}}
    if any(len(v) != CV_ROUNDS or not np.all(np.isfinite(v))
           for v in res.values()) or len(res) != 4:
        raise AssertionError(f"phase 21 (d): cv result {res}")
    log(f"phase 21 (d): cv {CV_FOLDS} folds x {CV_ROUNDS} rounds on "
        f"{len(ytr)} rows in {out['seconds']:.1f} s, paths {paths}, "
        f"valid l2 mean {res['valid l2-mean']}")
    del cvb
    base = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
            "tpu_use_f64_hist": True, "tpu_grow_mode": "leafwise",
            "metric": ["l2", "l1"]}
    dicts = [lt.cv({**base, "device_type": dev},
                   lt.Dataset(Xtr[:CV_CUT_ROWS], label=ytr[:CV_CUT_ROWS],
                              params={**base, "device_type": dev}),
                   num_boost_round=CV_ROUNDS, nfold=CV_FOLDS, seed=21)
             for dev in ("cuda", "cpu")]
    if dicts[0] != dicts[1]:
        raise AssertionError(f"phase 21 (d): the cut's cv results differ "
                             f"between the card and the CPU: {dicts}")
    out["cut"] = {"rows": CV_CUT_ROWS, "result": dicts[0]}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 21 (d): the {CV_CUT_ROWS}-row cut's cv results equal on "
        f"the card and the CPU; {out['seconds']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--holdout", type=int, default=500_000)
    ap.add_argument("--mslr-rows", type=int, default=MSLR_ROWS)
    ap.add_argument("--airline-rows", type=int, default=10_000_000)
    ap.add_argument("--only", choices=("21", "22"), help="phases 1-2 and "
                    "this phase alone (phase 21's kernels in the kernels "
                    "line)")
    ap.add_argument("--prefetch-ab", type=int, default=0, metavar="N",
                    help="phase 22: N streamed loads with and N without a "
                    "prefetch thread, (a) and (b) each")
    args = ap.parse_args()
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lt
    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        raise AssertionError("the port imported jax or lightgbm_tpu")
    dev = torch.device(DEVICE)
    info = phase_device(torch)
    stamps = [("start", time.perf_counter())]

    def stamp(what):
        # wall seconds of each stretch of phases, logged at the end
        stamps.append((what, time.perf_counter()))
    phase_build()
    sass = phase_sass()
    stamp("phases 1-2")
    if args.only == "21":
        kernels = u16_kernels(torch, lt, dev, args, stamp)
        return finish(torch, info, stamps, t_main, {}, kernels)
    if args.only == "22":
        check_native(lt)
        X, y = synth_higgs(args.rows, 28)
        ingest = {"higgs": phase_stream_higgs(torch, lt, X, y, args.rows,
                                              args.prefetch_ab)}
        del X, y
        gc.collect()
        ingest.update(phase_ingest(torch, lt, args.prefetch_ab))
        stamp("phase 22")
        return finish(torch, info, stamps, t_main, {"ingest": ingest}, [])
    par = phase_parity(torch, dev, args.rows)
    qpar = phase_quant_parity(torch, dev, args.rows)
    stamp("phases 3, 18 (a)")
    t0 = time.perf_counter()
    X, y = synth_higgs(args.rows + args.holdout, 28)
    log(f"data: {args.rows}+{args.holdout} x 28 synthetic rows in "
        f"{time.perf_counter() - t0:.3f} s")
    main_r, aligned_r, apar, level_r, lpar = {}, {}, {}, {}, {}
    bpar = {}
    for max_bin in (63, 255):
        ds, params, main_r[max_bin] = phase_main(torch, lt, X, y, args.rows,
                                                 max_bin)
        aligned_r[max_bin] = phase_aligned_main(
            torch, lt, ds, params, X, y, args.rows, max_bin, main_r[max_bin])
        if max_bin == 63:
            quant = phase_quant_train(torch, lt, ds, params, X, y,
                                      args.rows, main_r[63])
            forced = phase_forced_cegb(torch, lt, ds, params, X, y,
                                       args.rows)
            objectives = phase_objectives_higgs(torch, lt, ds, params, X, y,
                                                args.rows, aligned_r[63])
            big_n = phase_big_n(torch, lt, ds, params, X, y, args.rows)
            bagging = phase_bagging(torch, lt, ds, params, X, y, args.rows)
            bpar[(63, "standard")] = phase_bag_parity(
                torch, lt, ds, params, BAG, 63, "standard")
        else:
            bst, bagging["auto_255"] = bagged_aligned_run(
                torch, lt, ds, {**params, **BAG}, 3, X[args.rows:],
                y[args.rows:], "bagged auto 255", compact=True)
            del bst
        bpar[(max_bin, "compact")] = phase_bag_parity(
            torch, lt, ds, params, BAG, max_bin, "compact")
        for layout in ("compact", "standard"):
            apar[(max_bin, layout)] = phase_aligned_parity(
                torch, lt, ds, params, max_bin, layout,
                aligned_r[max_bin]["profile"])
        level_r[max_bin] = phase_level_main(
            torch, lt, ds, params, X, y, args.rows, max_bin, main_r[max_bin])
        if max_bin == 63:
            level_r["depth8"] = phase_level_depth(torch, lt, ds, params, X,
                                                  y, args.rows)
        lpar[max_bin] = phase_level_parity(torch, lt, ds, params, max_bin)
        del ds
        torch.cuda.empty_cache()
    stamp("phases 4-7, 11-13, 16, 18 (b), (c), 20 (b), (c)")
    f64_launches = phase_f64(torch, lt)
    stopping = phase_early_stopping(torch, lt, X, y)
    stamp("phases 8, 18 (d)")
    check_native(lt)
    ingest = {"higgs": phase_stream_higgs(torch, lt, X, y, args.rows,
                                          args.prefetch_ab)}
    stamp("phase 22 (b)")
    del X, y
    gc.collect()
    t0 = time.perf_counter()
    Xm, ym, gm = synth_mslr(args.mslr_rows, MSLR_FEATURES)
    log(f"data: {args.mslr_rows} x {MSLR_FEATURES} synthetic MSLR rows in "
        f"{len(gm)} queries, {time.perf_counter() - t0:.3f} s")
    rpar = phase_rank_parity(torch, lt, ym, gm)
    mds, mparams, mslr = phase_mslr(torch, lt, Xm, ym, gm)
    apar[(255, "ext")] = phase_aligned_parity(torch, lt, mds, mparams, 255,
                                              "ext",
                                              mslr["aligned"]["profile"])
    ext_bag = phase_ext_bag(torch, lt, mds, mparams)
    bpar[(255, "ext")] = ext_bag["kernels"]
    stamp("phases 9-11 (MSLR)")
    del mds, Xm, ym, gm
    gc.collect()
    torch.cuda.empty_cache()
    info["state_phase14"] = card_state("phase 14")
    proto_path = phase_proto_path(torch)
    ppar = phase_proto_parity(torch)
    stamp("phase 14")
    gc.collect()
    torch.cuda.empty_cache()
    airline = phase_airline(torch, lt, args.airline_rows, args.holdout)
    stamp("phase 15")
    gc.collect()
    torch.cuda.empty_cache()
    mc = phase_multiclass(torch, lt)
    mpar = phase_mc_parity(torch, lt)
    stamp("phase 17")
    gc.collect()
    torch.cuda.empty_cache()
    efb = phase_efb(torch, lt, args.airline_rows, args.holdout, t_main)
    stamp("phase 19")
    gc.collect()
    torch.cuda.empty_cache()
    year = phase_year(torch, lt)
    stamp("phase 20 (a), (d)")
    gc.collect()
    torch.cuda.empty_cache()
    u16_entries = u16_kernels(torch, lt, dev, args, stamp)
    gc.collect()
    torch.cuda.empty_cache()
    ingest.update(phase_ingest(torch, lt, args.prefetch_ab))
    stamp("phase 22 (a), (c)-(e)")

    def entry(name, replaces, bins, prec, launches):
        p = par[bins]
        leaf = p["gathered"]["small child"] if prec == "f32" else {}
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": (p["max_abs_err_f32"] if prec == "f32"
                                else 0.0),
                "ms": p[f"ms_{prec}"], "plain_ms": p[f"plain_ms_{prec}"],
                "bound_ms": p[f"bound_ms_{prec}"],
                "bound_by": p[f"bound_by_{prec}"],
                "library_ms": p[f"library_ms_{prec}"],
                **{f"leaf_{k}": leaf[k] for k in (
                    "ms", "cold_ms", "plain_ms", "library_ms", "bound_ms")
                   if k in leaf},
                "shape": f"root {args.rows}x28, {bins} bins, {prec}"
                         + (f"; leaf: {leaf['rows']} gathered rows"
                            if leaf else "")}

    def aentry(name, kernel, line, bins, layout, launches, shape,
               dims=f"{args.rows}x28"):
        p = apar[(bins, layout)][kernel]
        return {"name": name, "route": "cuda", "source": ALIGNED_SOURCE,
                "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
                "launches": launches, "max_abs_err": p["max_abs_err"],
                "ms": p["ms"], "plain_ms": p["plain_ms"],
                "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                "library_ms": p["library_ms"],
                **{k: p[k] for k in ("wrapper_ms", "cold_ms",
                                     "launches_per_call") if k in p},
                "shape": f"{shape}, {dims}, {bins} bins, {layout}"}

    kernels = [
        entry("histogram_f32_63bin", "lightgbm_tpu/ops/pallas_hist.py:205",
              63, "f32", main_r[63]["launches"]["B1"]),
        entry("histogram_f32_255bin", "lightgbm_tpu/ops/pallas_hist.py:188",
              255, "f32", main_r[255]["launches"]["B1"]),
        entry("histogram_f64", "lightgbm_tpu/ops/histogram.py:39", 63,
              "f64", f64_launches["leafwise"]),
    ]
    # B1's integer branch: the 63-bin root's numbers, the gathered leaf's
    # and the 255-bin ones beside them; launches from phase 18 (b)
    for bits in (8, 16):
        p = qpar[f"63 int{bits} root"]
        kernels.append({
            "name": f"histogram_int{bits}", "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:205",
            "launches": quant[bits]["launches"][f"B1_i{bits}"],
            "max_abs_err": 0.0, "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"], "cold_ms": p["cold_ms"],
            "launches_per_call": p["graph"]["kernels"],
            **{f"{k.replace(' ', '_')}_{m}": qpar[k][m]
               for k in (f"63 int{bits} leaf", f"255 int{bits} root",
                         f"255 int{bits} leaf")
               for m in ("ms", "cold_ms", "plain_ms", "library_ms",
                         "bound_ms")},
            "shape": f"root {args.rows}x28, 63 bins, int{bits} payload "
                     "(the integer branch of pallas_hist.py:167-171)"})
    for bins in (63, 255):
        launches = aligned_r[bins]["launches"]
        kernels.append(aentry(f"move_pass_partition_{bins}bin",
                              "partition", 960, bins, "compact",
                              launches["move_pass"],
                              "partition of the widest round of tree 1"))
        kernels.append(aentry(f"move_pass_child_hist_{bins}bin",
                              "child_hist", 960, bins, "compact",
                              launches["move_pass"],
                              "smaller children of the widest round of "
                              "tree 1"))
        kernels.append(aentry(f"slot_hist_pass_{bins}bin", "slot_hist_pass",
                              1141, bins, "compact",
                              launches["slot_hist_pass"], "root pass"))
    kernels.append(aentry("count_pass", "count_pass", 1056, 63, "standard",
                          big_n["launches"]["count_pass"],
                          "widest round of tree 1"))
    launches = mslr["aligned"]["launches"]
    dims = f"{args.mslr_rows}x{MSLR_FEATURES}"
    kernels.append(aentry("move_pass_partition_ext_255bin", "partition",
                          960, 255, "ext", launches["move_pass"],
                          "partition of the widest round of tree 1", dims))
    kernels.append(aentry("move_pass_child_hist_ext_255bin", "child_hist",
                          960, 255, "ext", launches["move_pass"],
                          "smaller children of the widest round of tree 1",
                          dims))
    kernels.append(aentry("slot_hist_pass_ext_255bin", "slot_hist_pass",
                          1141, 255, "ext", launches["slot_hist_pass"],
                          "root pass", dims))
    for bins, line, prec, b5_launches in (
            (63, 293, "f32", level_r[63]["launches"]["B5"]),
            (255, 276, "f32", level_r[255]["launches"]["B5"]),
            (63, 293, "f64", f64_launches["level"])):
        p = lpar[bins]["root"]
        kernels.append({
            "name": f"histogram_words_{bins}bin" if prec == "f32"
            else "histogram_words_f64", "route": "cuda",
            "source": WORDS_SOURCE,
            "replaces": f"lightgbm_tpu/ops/pallas_hist.py:{line}",
            "launches": b5_launches,
            "max_abs_err": max(r["max_abs_err"]
                               for r in lpar[bins].values())
            if prec == "f32" else 0.0,
            "ms": p[f"ms_{prec}"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"],
            "shape": f"root {p['rows']}x28, {bins} bins, {prec}"})
    rp = rpar["mslr"]
    kernels.append({
        "name": "lambdarank_grad", "route": "cuda", "source": RANK_SOURCE,
        "replaces": "lightgbm_tpu/ops/pallas_rank.py:345",
        "launches": launches["lambdarank_grad"],
        "max_abs_err": rp["max_abs_err"], "ms": rp["ms"],
        "plain_ms": rp["plain_ms"], "bound_ms": rp["bound_ms"],
        "bound_by": rp["bound_by"], "library_ms": None,
        "shape": f"{rp['docs']} docs in {rp['queries']} queries (MSLR)"})
    for name, key, line, launches, shape in (
            ("move_pass_partition_cat_255bin", "partition_cat", 960,
             airline["auto"]["launches"]["move_pass_cat"],
             "partition of the widest round of tree 1, COMPACT"),
            ("count_pass_cat", "count_cat", 1056,
             airline["big_n"]["launches"]["count_pass_cat"],
             "count pass of the widest round of tree 1, STANDARD")):
        p = airline["kernels"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": ALIGNED_SOURCE,
            "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
            "launches": launches, "max_abs_err": p["max_abs_err"],
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"],
            **{k: p[k] for k in ("wrapper_ms", "cold_ms",
                                 "launches_per_call") if k in p},
            "shape": f"{shape}, airline {args.airline_rows}x8, 255 bins, "
                     "categorical"})
    # the bag branch of B4 and B2's children, B3 on COMPACT records
    for bins, layout, run, dims in (
            (63, "compact", bagging["auto"], f"{args.rows}x28"),
            (255, "compact", bagging["auto_255"], f"{args.rows}x28"),
            (63, "standard", bagging["big_n"], f"{args.rows}x28"),
            (255, "ext", ext_bag, f"{args.mslr_rows}x{MSLR_FEATURES}")):
        tag = f"{bins}bin" if layout == "compact" else f"{layout}_{bins}bin"
        for name, key, line, launch_key, shape in (
                (f"slot_hist_pass_bag_{tag}", "slot_hist_bag", 1141,
                 "slot_hist_pass_bag", "root pass of a bagged tree"),
                (f"move_pass_child_hist_bag_{tag}", "child_hist_bag", 960,
                 "move_pass_bag", "smaller children of the widest round "
                 "of a bagged tree"),
                (f"count_pass_compact_{bins}bin", "count_compact", 1056,
                 "count_pass", "count pass of the widest round of a "
                 "bagged tree")):
            p = bpar[(bins, layout)].get(key)
            if p is None:
                continue
            kernels.append({
                "name": name, "route": "cuda", "source": ALIGNED_SOURCE,
                "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
                "launches": run["launches"][launch_key],
                "max_abs_err": p["max_abs_err"], "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": p["bound_by"], "library_ms": p["library_ms"],
                **{k: p[k] for k in ("unbagged_ms", "wrapper_ms",
                                     "cold_ms") if k in p},
                "shape": f"{shape}, {dims}, {bins} bins, {layout}"})
    # the class kinds of B4 and B2's children, B2 and B3 on K-class records
    mc_dims = f"Covertype {MC_KERNEL_ROWS}x12, 63 bins, COMPACT, K = 7"
    for name, key, line, run, launch_key, shape in (
            ("slot_hist_pass_mc_prob", "slot_hist_prob", 1141, mc["auto"],
             "slot_hist_pass_class", "root pass, softmax"),
            ("slot_hist_pass_mc_prob_bag", "slot_hist_prob_bag", 1141,
             mc["bag"], "slot_hist_pass_class", "root pass, softmax, bagged"),
            ("slot_hist_pass_mc_score", "slot_hist_score", 1141, mc["ova"],
             "slot_hist_pass_class", "root pass, one-vs-all"),
            ("slot_hist_pass_mc_score_bag", "slot_hist_score_bag", 1141,
             mc["ova_bag"], "slot_hist_pass_class",
             "root pass, one-vs-all, bagged"),
            ("move_pass_child_hist_mc_prob", "child_hist_prob", 960,
             mc["auto"], "move_pass_class",
             "smaller children of the widest round, softmax"),
            ("move_pass_child_hist_mc_prob_bag", "child_hist_prob_bag", 960,
             mc["bag"], "move_pass_class",
             "smaller children of the widest round, softmax, bagged"),
            ("move_pass_child_hist_mc_score", "child_hist_score", 960,
             mc["ova"], "move_pass_class",
             "smaller children of the widest round, one-vs-all"),
            ("move_pass_child_hist_mc_score_bag", "child_hist_score_bag",
             960, mc["ova_bag"], "move_pass_class",
             "smaller children of the widest round, one-vs-all, bagged"),
            ("move_pass_partition_mc", "partition", 960, mc["auto"],
             "move_pass", "partition of the widest round, W = 24 (and of "
             "the root on K = 31 records, W = 72: k31_*)"),
            ("count_pass_mc_bag", "count_bag", 1056, mc["bag"],
             "count_pass", "count pass of the widest round, bagged")):
        p = mpar[key]
        kernels.append({
            "name": name, "route": "cuda", "source": ALIGNED_SOURCE,
            "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
            "launches": run["launches"][launch_key],
            "max_abs_err": p["max_abs_err"], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": p["library_ms"],
            **{k: v for k, v in p.items() if k.startswith("k31_")
               or k in ("cold_ms", "wrapper_ms")},
            "shape": f"{shape}, {mc_dims}"})
    # the bundled branch of B2's partition and of B3 (phase 19)
    for name, key, line, launches, shape in (
            ("move_pass_partition_bundled", "partition_bundled", 960,
             efb["auto"]["launches"]["move_pass_bundled"],
             "partition of the widest round of tree 1, COMPACT"),
            ("count_pass_bundled", "count_bundled", 1056,
             efb["big_n"]["launches"]["count_pass_bundled"],
             "count pass of the widest round of tree 1, STANDARD")):
        p = efb["kernels"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": ALIGNED_SOURCE,
            "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
            "launches": launches, "max_abs_err": p["max_abs_err"],
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"],
            **{k: p[k] for k in ("wrapper_ms", "cold_ms", "unbundled_ms",
                                 "unbundled_cold_ms", "launches_per_call")
               if k in p},
            "shape": f"{shape}, one-hot airline {args.airline_rows}x"
                     f"{efb['dataset']['features']} in "
                     f"{efb['dataset']['storage_cols']} storage columns, "
                     "255 bins, bundled"})
    # the pointwise objective kinds of B4 and B2's children (phase 20)
    for kind, kp in objectives["kinds"].items():
        for name, case, line, launch_key, shape in (
                (f"slot_hist_pass_{kind}", "root", 1141, "slot_hist_pass",
                 "root pass"),
                (f"move_pass_child_hist_{kind}", "children", 960,
                 "move_pass", "smaller children of the widest round")):
            p = kp[case]
            kernels.append({
                "name": name, "route": "cuda", "source": ALIGNED_SOURCE,
                "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
                "launches": kp["launches"][launch_key],
                "max_abs_err": p["max_abs_err"], "ms": p["ms"],
                "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                "bound_by": p["bound_by"], "library_ms": p["library_ms"],
                **{k: p[k] for k in ("cold_ms", "binary_ms",
                                     "binary_cold_ms", "rows")},
                "shape": f"{shape}, {args.rows}x28, 63 bins, COMPACT, the "
                         f"{kind} kind (the objective's gradient of "
                         "_payload_gh, aligned.py:350-383)"})
    plaunch = proto_path["launches"]
    rows = proto_path["aligned"]["rows"]
    proto_entries = (
        ("proto_slot_hist", "tools/proto_aligned.py:127", "slot_hist",
         ppar["slot_hist"], "C=256 B=256 group=4",
         f"{rows} rows, chunks of 256, 384 slots, 28 features, b_pad 256"),
        ("proto_move", "tools/proto_aligned.py:299", "move", ppar["move"],
         "C=256", f"{rows} rows, chunks of 256, one block"),
        ("proto_route4c", "tools/proto_roll.py:141", "route4c",
         ppar["ring"], "route4c", "20000 x 512"),
        ("proto_compact_roll", "tools/proto_roll.py:141", "compact_roll",
         ppar["ring"], "compact_roll", "20000 x 512"))
    for name, replaces, key, table, config, shape in proto_entries:
        p = table[config]
        kernels.append({
            "name": name, "route": "cuda", "source": PROTO_SOURCE,
            "replaces": replaces, "launches": plaunch[key],
            "max_abs_err": max(r["max_abs_err"] for r in table.values()),
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"],
            **{k: p[k] for k in ("wrapper_ms", "cold_ms",
                                 "launches_per_call") if k in p},
            "shape": shape})
    kernels += u16_entries
    return finish(torch, info, stamps, t_main, {
        "hist_kernel": {str(k): v for k, v in par.items()},
        "main": {str(k): v for k, v in main_r.items()},
        "aligned": {str(k): v for k, v in aligned_r.items()},
        "big_n": big_n,
        "aligned_kernels": {f"{b} {lay}": v for (b, lay), v
                            in apar.items()},
        "level": {str(k): v for k, v in level_r.items()},
        "level_kernel": {str(k): v for k, v in lpar.items()},
        "mslr": mslr, "rank_kernel": rpar,
        "airline": airline, "bagging": bagging,
        "multiclass": mc, "mc_kernels": mpar, "efb": efb,
        "objectives": {"higgs": objectives, "year": year},
        "quant_kernel": qpar, "quant": quant,
        "forced_cegb": forced, "early_stopping": stopping,
        "ingest": ingest,
        "bag_kernels": {f"{b} {lay}": v for (b, lay), v
                        in bpar.items()},
        "proto_path": proto_path, "proto_kernels": ppar,
        "sass_atomics": sass,
        "card": {k: info[k] for k in ("state", "state_phase14")}},
        kernels)


def u16_kernels(torch, lt, dev, args, stamp) -> list:
    """Phase 21, and its entries of the kernels line: B1's uint16 route
    in each precision, its numbers from (a) (the root's, the gathered
    leaf's as ``leaf_*``), its launches from (b)'s runs."""
    u16 = phase_u16_parity(torch, lt, dev)
    gc.collect()
    torch.cuda.empty_cache()
    air = phase_u16_airline(torch, lt, args.airline_rows, args.holdout)
    gc.collect()
    torch.cuda.empty_cache()
    files = phase_files(torch, lt)
    stamp("phase 21")
    log(json.dumps({"phase21": {"kernel": u16, "airline": air,
                                "files": files}}, default=str))
    launches = {"f32": air["leafwise"]["launches"]["B1_u16_f32"],
                "f64": air["cut_f64_launches"],
                "i8": air["quant8"]["launches"]["B1_u16_i8"],
                "i16": air["quant16"]["launches"]["B1_u16_i16"]}
    out = []
    for kind, name in (("f32", "histogram_u16_f32"),
                       ("f64", "histogram_u16_f64"),
                       ("i8", "histogram_u16_int8"),
                       ("i16", "histogram_u16_int16")):
        p, leaf = u16[f"root {kind}"], u16[f"leaf {kind}"]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:205",
            "launches": launches[kind],
            "max_abs_err": max(p["max_abs_err"], leaf["max_abs_err"]),
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"], "cold_ms": p["cold_ms"],
            **{f"leaf_{k}": leaf[k] for k in ("ms", "cold_ms", "plain_ms",
                                              "library_ms", "bound_ms")},
            "shape": f"root {u16['rows']}x28, {u16['bins']} bins, uint16, "
                     f"{kind}; leaf: {U16_LEAF_ROWS} gathered rows (the "
                     "uint16 route of pallas_hist.py:205, which casts its "
                     "bins to uint8: ROADMAP C.32)"})
    return out


def finish(torch, info, stamps, t_main, results, kernels) -> int:
    """The run's end: every kernel of the line launched on its main path,
    the wall seconds of each stretch, the results, the kernels line and
    the contract's last line."""
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on its "
                                 "main path")
    log("wall s: " + ", ".join(
        f"{what} {t - stamps[i][1]:.1f}"
        for i, (what, t) in enumerate(stamps[1:])))
    log(f"chip_smoke: {time.perf_counter() - t_main:.1f} s")
    log(json.dumps({**results, "power": info["smi"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
