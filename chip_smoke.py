#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pixie_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --only-cpu-route   (the kernel build and the
                                              cpu_route phase alone)
    python3 chip_smoke.py --only-host-layers (the kernel build and the
                                              host_layers phase alone)
    python3 chip_smoke.py --only-metadata-collect (the kernel build and
                                              the metadata_collect phase
                                              alone)

Phases, each of which fails the run if it fails:

  1. device   — the card's name, and name + power limit from nvidia-smi;
  2. build    — every kernel under pixie_tpu_torch/csrc/ built with nvcc
                (all sources at once) and loaded;
  3. kernels  — each kernel held against its plain PyTorch version on the
                same CUDA tensors, at the main path's shapes and at edge
                cases (int64 sums that wrap, an all-false mask, one group,
                more groups than shared memory holds, values on sketch bin
                edges and <= 1e-9, K2 over values 20% NaN at NaN bins 0
                and 1 in both its regimes — one block's shared memory
                and global atomics — and with its inputs one value past
                alignment).  Integer results and the quantiles must
                match exactly, float64 sums to 1e-12 of each group's sum
                of |values|.  Each kernel is
                timed (CUDA events) beside its plain version, the nearest
                single PyTorch library call and its bound on the card.
                The phase also holds K4 (stable compaction) against its plain
                version at 2^24 rows of 4 columns (int32, int64, f64, bool)
                and mask densities 0.9, 0.1, 1, 0, 0.001 and 0.5, exactly
                and in order, timed at 0.1 and 0.9 (with its device time
                and host microseconds a call);
                J1-J3 (the join's build, probe and expand) stage by stage at
                bench's device-join shape (16M x 16M codes uniform in
                [0, 16M), seed 11; J1's cnt, first and rows_by_code exactly,
                rows ascending within a code), J1 also timed at the device
                join phase's build side (2^22 rows, codes in [0, 2^20)) and
                with half the 16M rows on one code, each held exactly and
                twice to the same bits, and through device_join_codes at
                edge cases (one key with 4096 rows a side, no matches,
                all-null probe codes, wide sparse codes), as exact pair sets
                and matched flags; and
                times K1 min/max at the sorted path's shape (a 2^20-row
                chunk into 2^23 groups: the global route) and at config
                #1's feed shape (G = 64: shared memory), each with its
                device time, host microseconds a call and the 32-byte
                sector figure beside its bound, and K1's count, int64 sum
                and f64 sum at the sorted chunk (S1's other leaves, held
                exactly and to 1e-12); on both shapes K1's f64 and f32 min
                and max over values 1% NaN with +-0.0 and +-inf into a
                state that enters holding NaN of either sign, against the
                plain version with NaN compared as NaN (every entering NaN
                stays, a NaN a row brings is the op's own); J2 timed at
                the device join phase's shape (2^22 x 2^22, codes in
                [0, 2^20)) with its tiles, and J2 + J3 there as the join
                runs them (J3 given J2's tiles) and as two stages that each
                count; J3 held with and without J2's tiles; and K3 at 64
                and at S2's 4,096 groups (CUDA events, device time, host
                microseconds a call), its warm call profiled for
                host-to-device copies (0 wanted);
  4. slice    — bench config #1 (filter status != 404, group by service and
                status, count / mean / p50 of latency) over an http_events
                table of 64M rows (bench's headline size) built with the
                port's TableStore, run through
                execute_plan(device="cuda"), checked against a numpy oracle
                (counts exact, means to rtol 1e-9, p50 in the oracle's sketch
                bin or the next one, and within 2.1% of np.median), with
                every kernel of the path launched at least once; then timed
                warm (median of 5 runs after 2 warm-ups);
  5. select   — over the same table: filter status == 500, select time_,
                service, latency, status (~6.4M rows), and the same with
                head(100000); rows and their order equal to a numpy oracle;
                each timed warm (median of 5 after 2 warm-ups);
  6. config3  — bench_config3 (16M network_stats rows, 256 pods, seed 5,
                sums per pod, joined with the 256-row pods table, sums per
                service): 24 rows with the oracle's exact int64 sums; the
                join is below the device gate and matches on the host;
  7. join     — an inner join of two 2^22-row tables (k uniform in
                [0, 2^20), seed 9) through execute_plan(device="cuda"): one
                device join (J1-J3) with gate reason h2d_direct_attached,
                sorted (k, a, b) rows equal to a numpy oracle's; timed warm,
                and one analyze run splits it into host key codes, H2D,
                J1-J3 and D2H (--profile adds the device trace);
  8. resident — config #1 over an 8M-row http_events table (one feed, the
                only shape in which the reference folds): a cold query
                admits it (R1), a warm one moves 0 bytes; 2^20 rows appended
                in 16 sealed batches fold in with a grow from 2^23 to 2^24
                rows (R2, R1) and move exactly the delta's bytes; then the
                same on a table whose budget holds 9M rows, where appending
                2^21 rows trims 2^20 and the next query rebases (R2), grows
                and folds.  Each result equals the stream route's and the
                numpy oracle's;
  9. config4  — bench config #4 from PxL text: 8 agent stores of 2M rows
                built as bench_config4 builds them (seed 12 each, so their
                dictionaries agree), bench's script through
                LocalCluster.query: the agents run concurrently on the card
                and their states merge there in exactly one M1 launch per
                query, written packed and read back with no P1 launch;
                held against a numpy oracle over all 16M rows as
                config #1 is; a stream and a warm median (5 each; warm moves
                0 H2D bytes and the plan cache serves the compile and the
                split), both profiled for the device's idle share.  Then the
                mixed-dictionary run: 8 x 1M rows, agent a holding services
                a..a+7 (mod 16), which takes the host value-keyed merge
                with M1 never launched and each agent's state packed by P1
                (8 launches a query), against the same oracle;
 10. sorted   — a 16M-row table (seed 13: conn_id uniform on [0, 2^23),
                bytes, latency exponential(50)): S1 groups by conn_id
                (~7.25M groups, past MAX_GROUPS) with count, sum(bytes),
                mean, min and max(latency); S2 groups by bin(bytes, 4096)
                (a computed key) with count, mean and p50(latency).  Each
                takes the sorted fallback once and equals a numpy oracle.
 11. ml       — (1) kmeans_fit of 2^20 points (d = 64, 64 gaussian blobs,
                seed 17) with k = 64 and 10 iterations, three times: the
                fits are identical, every true center has a fitted one
                within 0.5 sigma, and each fit launches KM3 63 times, KM2 10
                and KM1 once; (2) CoresetTree(m=1024, k=8) over 64 batches
                of 2^16 x 64 points (8 blobs): query() holds at most 1024
                points of total weight within 5% of the stream's, and a fit
                on it recovers the 8 centers within 1 sigma per dimension
                (root mean square); (3) from PxL text over an 8M-row
                http_events table (16 services, 200 request paths from 20
                templates): _build_request_path_clusters per service, merged
                back on service, _predict_request_path_cluster per row and a
                count per endpoint, equal to a numpy oracle that templatizes
                the paths itself; (4) _kmeans_fit per service over the
                table's 256 _text_embedding strings: 16 models, each within
                1e-4 of the port's plain route (the CPU) fitting the same
                group with the card's draws, except a model whose plain fit
                came within 1e-5 of a tie (two centers equidistant from a
                point, or a sample on a boundary of its cumulative sum),
                which the card's rounding may break the other way; more
                than half the models must be compared.  KM1-KM3 and K1's
                count must launch; KM1's launches are also counted by shape.
Config #1, the select and config #3 each report a stream median (the tier
off, the feed cache off and empty: every feed uploaded, the route measured
before the tier) and a warm median (after the admitting queries; a warm
query that moves any host-to-device byte fails the phase), with the bytes
moved and the feeds served from the tier and the cache.  Each slice phase
resets the launch counts just before its first query and reads them just
after; a kernel of the phase that did not launch fails it.  The kernel
phase also holds R1 and R2 (the resident tier's fold and move) against
their plain versions at 2^20 rows x 4 columns into 2^24 rows, a grow from
2^23 to 2^24 rows and a rebase dropping 2^20 of 2^24 rows, and M1 (the
cross-agent state merge) at config #4's state (8 states of 64 groups), at
a bandwidth shape (8 states of 2^16 groups with min and max, ~138 MB each)
and past one launch's parameter block (17 states over 250 leaves: two
launches), exactly, each with its host microseconds a call (200 calls, no
synchronize) beside its CUDA-event and device times (device: CUDA events
around calls enqueued while the device sleeps, `kernel_device_ms`), and
KM1-KM3 (the k-means assignment, Lloyd sums and seeding step)
at the fit's shape (2^20 x 64 points, 64 centers) and at edge cases (k = 1,
k > a block's 256 points, d = 13, d = 150 with k = 200, k = 129, k = 9, 33
and 65 and d = 65 (where the center and column tiles turn), n one short of
and one past the 128-point tile, one tile past the capped grid, every point
on one center, rows holding NaN, a cluster of zero weight), to
1e-5 of |x|^2 + |c|^2 (distances, p) and of the sums of |w x| (xsum), ids
equal outside near-ties, NaN in the same places, unit-weight counts
exactly (and equal to KM1's ids' counts), KM2 the same bits twice and with
its sums in shared memory; KM1 and KM2 are also held and timed at the
coreset's shapes (a 2^16 x 64 leaf with k = 8, a 2,048-point merge), KM3
at the leaf.

Then, over config #1's 64M-row table (after config #2's phase): G1 (the
multi-query gang) on the table's first 16M-row feed with the four
BATCH_SCRIPTS members of the reference's load harness, held against its
plain version and against the per-sink route (each member's C1 and K1/K2
launches) on the same tensors — counts, int64 sums, min, max and sketch
cells exactly, float64 sums to rtol 1e-12 — on the same feed with its
latencies 20% NaN at NaN bins 0 and 1, again with a member of 2^20 groups
added (global atomics), and past one launch's table (24 members: two
launches), timed by CUDA events, its device time and its host
microseconds a call; and the batch phase: the four
scripts through LocalCluster.query from 16 client threads (4 per script, 8
queries each), unbatched (PL_QUERY_BATCHING=0, PX_MQ_FUSION=0) and then
batched (both on), each result equal to the script's solo result, which
equals a numpy oracle (counts exact, means to rtol 1e-9, max and min
exact, p50 and p99 in the oracle's sketch bin or the next); per arm the
goodput, the p50 latency, the batches formed and their median size,
mq_fused, mq_waves and G1's launches per batch.  The phase fails unless a
batch formed and G1 launched, or if a warm batch's CUDA-only profile holds
a host-to-device copy.

The device finalize (slice 9): an unlimited aggregate over several feeds
runs the per-feed route (C1, K1, K2) and then F2 once (the merge of the
shards' states, N = 1 without a mesh, the sketches' quantiles and the pack
into one buffer: one readback), so config #1, config #2 and mesh config #1
launch F2 and no K3 (mesh config #1 no M1); an aggregate of one feed is one
F1 launch (the resident phase, config #3); raw partial states read back
packed by P1 (the batch phase, the mixed-dictionary run), while M1 writes a
merged state packed, so config #4 and the mesh cluster launch no P1.  After G1's check, F1 is held
against its plain version and the per-sink route on the 64M-row table's
first 16M-row feed (config #1's chain; its first 1M rows; the feed 20% NaN
at both NaN bins; config #2's chain at 1,024 groups), each with its device
time and host microseconds a call;
F2 at N = 1, N = 4 (the four feeds' states) and 8 states of 2^16 groups,
beside M1 + K3;
P1 on config #4's state and a 2^20-group state, beside torch.cat per dtype
(each with its host microseconds a call), and past one launch's table
(2,000 leaves: two launches) — counts, int64 sums, min, max, quantiles and packed bytes exactly, float64
sums to rtol 1e-12.  The one-feed phase (after mesh config #1) runs config
#1 on bench's build_http_table at 16M rows and at 1M rows: one F1 launch a
warm query and no other kernel, one D2H wave and no host-to-device copy in
its CUDA-only profile, the oracle, stream and warm medians; then the 16M
rows in two feeds (PX_FEED_ROWS = 2^23: C1 twice, F2 once), equal to F1's
result.  Before the ml phase, row 18's yardstick: K1's
count over gid * 256 + code beside torch.bincount.

Then the mesh phases (slice 8; PIXIE_TORCH_VIRTUAL_SHARDS = 4 for them
only, restored after).  The kernel phase also holds X1 and X2 (the in-mesh
repartition's hash-and-count and stable scatter, csrc/repartition.cu)
against their plain versions at 2^24 rows (an int64 and a dictionary key,
f64 and int64 values) over 4 and 8 partitions and with one key holding half
the rows, exactly, and M1 as the collective merge of 4 shards of config
#1's state (with its host microseconds a call) and past one launch's
parameter block.  Mesh config #1: config #1 over the 64M-row table with a mesh
of 4 co-located shards (each feed in 4 row blocks, each shard's C1, K1 and
K2 into its own state, F2 once over the 4 states), equal to the single-device executor
(counts and p50 exactly, means to 1e-12) and the oracle, spmd_feeds 4, a
stream and a warm median (0 warm H2D bytes: the sharded resident entry).
Mesh cluster: a LocalCluster of 2 agents of 4 shards: config #4's script
over 2 x 8M rows, equal to the one-device-per-agent cluster and the oracle
(M1 3 times a query: each agent's shards, then the agents; P1 never),
stream and
warm medians; a repartitioned join of two 2^21-row tables (cut from
2^22 for the run's time) spread over both
agents on (int64, string) keys, each side exchanged in each agent's mesh
(X1, X2), equal to the single-device join (run once with analyze, for its
operator times) as sorted frames; one agent's side exchanged in the mesh
and on the host, equal and each timed; and the same join with one agent at
one device (a host exchange beside a mesh one).

Slice 18 (views off in every other phase): the union phase, right after
config #1 over its 64M-row table: `a.append(b)` of the status-500 and
status-404 rows (~9.6M) grouped by service (count, mean, p50) from PxL
text, each parent through C1 and K4, the aggregate over the union's host
batch (one F1 launch), against a numpy oracle as config #1, the median of 5
warm runs, its launches and H2D bytes; the matview phase, after config
#4, on config #4's 8 agent stores of 2M rows with standing views on: query
1 registers (a rescan, M1 once), query 2 builds (each agent's state pulled
to the host), queries 3-7 are hits that must scan no row and launch no C1,
then 2^20 rows (16 batches of 65,536, another seed) are appended to pem0
and query 8 folds them (rows_folded 2^20 on pem0 alone: C1, K1, K2 and P1
over the delta, which is uploaded); every answer equals a fresh views-off
cluster (cnt and p50 exactly, avg_lat to rtol 1e-12); and the shard_bench
phase, after the mesh cluster (4 co-located shards): run_local at 2^26 rows
(3 repeats, bit_equal) and run_shuffled_join at 2^21 rows a side (X1 and X2
on both sides, J1-J3 a partition, bit_equal), each arm's launches read
from one more warm query of its path alone.

Slice 19: every phase above runs pinned to the card route (PX_AUTOTUNE=0
and PX_CPU_CROSSOVER_ROWS=0, set before the port is imported so worker
processes inherit them; one "pinned" line a phase, printed from those
flags), so no aggregate or join moves onto the host fast paths or under
autotune's probes, and every launch, H2D and readback check holds as
before.  Last, the cpu_route phase
(`run_cpu_route`): g++ builds the native library; config #1 over
build_http_table at 2^14, 2^16, ..., 2^24 rows with each arm pinned, the
warm median of 5 of each and the CPU route's cold wall, every CPU-routed
query moving 0 H2D bytes and launching nothing and agreeing with the card
route (counts and integers exactly, floats to rtol 1e-12, the quantiles in
the same sketch bin or the adjacent one; the raw states' sketch values at
most one bin apart, counted); the default crossover, the largest size at
which the CPU route's warm median beats the card's (0 if none), beside the
flag's; with autotune off and that crossover, each size's unpinned run on
the arm it says, and with autotune on (the port's default) config #1 at
2^20 and 2^24 rows unpinned against pinned to the card, p50 and p99 of 100
queries each, with no cpu_crossover decision taken while the crossover is
0; the np_partial query (groupby service: count, mean, p99)
at 2^20 rows; config #4's 8 stores of 2^18 rows through LocalCluster,
routed by the query's 2,097,152 rows; the native host join against J1-J3
at 2^16 rows a side (equal pair sets and flags); and autotune_bench's A/B
with the static crossover mis-set (its answers held by those tolerances).

Slice 20, the multihost phase (after shard_bench): shard_bench.run_subprocess
at bench.py's sharded_agg_64m size (64M rows, 2 worker processes x 4
shards, 3 repeats), both ranks on this one card over gloo (a shared-card
figure, not a multi-card one), each rank feeding only its shards: rank 0
bit-equal to the single-device step over the full data, both ranks the same
merged bytes, and on every rank a step that launches C1, K1 (count, int64
sum, min, max), K2 and M1 exactly twice (its shards, then the world's
buffers); then each rank's keyed exchange of 2^21 rows (X1, X2, K4 and one
all_to_all_single a column), every block held against the sender's rows;
then a one-rank NCCL world in this process whose world merge of 4 shards of
config #1's state equals M1 and its plain version bit for bit (and a
one-rank gloo group beside it says whether gloo takes CUDA tensors).  Backend,
processes, shards, rows, rows/s, p50, launches, the world merge's gathered
bytes and wall and the exchange's bytes and wall are printed.

Slice 21, the host_layers phase (last, after cpu_route, pinned; alone:
--only-host-layers): (a) config #1 over build_http_table's 64M rows declared
with semantic types, through execute_plan and through a one-agent
LocalCluster, each with tracing (PL_TRACING_ENABLED) on and off in turns
(warm medians of 5, twice each way), the answers equal (counts and p50
exactly, means to rtol 1e-12: K1's float64 atomics add in another order
each run), the heat model's rows equal to the rows scanned, the profile and
op_stats rows the traced cluster wrote, and 0 H2D copies in a warm traced
query's CUDA-only profile; (b) the result's semantic types against the
port's CPU run of the plan; (f) 4M rows of config #1 as 16 tablets by
service (cut from 64M: the routing's host np.unique), the whole group and
one tablet against a plain table, cold and warm; (c) config #4 over
LocalCluster (8 x 2M rows) with explain=True: per-op ns with the device
synchronized, one plan verification cold and none over 5 warm queries, and
a split with a dtype flipped across a shuffle refused before any launch;
(d) the same stores written with the journal on (PL_JOURNAL_FSYNC always)
under a temporary PL_DATA_DIR, ingest rows/s with and without it, replayed
into fresh stores that answer as the live ones; (e) the stores written with
the cold tier on and PL_COLD_MAX_HOT_MB 29 (half the 256 batches demote),
three queries equal to the live answer, the cold tier in the heat model, no
cold batch resident or cached, every cold batch promoted at the third read;
(g) a view's snapshot restored into a new manager, serving the live hit's
state byte for byte.  Every line carries the card's name and power limit.

Slice 22, the metadata_collect phase (last, pinned; alone:
--only-metadata-collect), under a metadata snapshot of 1,088 UPIDs (1,024
on 4 nodes bound to 256 pods of 16 services in 4 namespaces, 64 with no
pod) and with the perf profiler sampling the process at 99 Hz throughout:
the canonical http_events relation (collect/schemas.py, 18 columns) at
64M rows in 65,536-row batches (the UPID column written as uint64 words);
the ctx query (resp_status != 404, df.ctx['service'] and ['namespace'],
group by service and status: count, int64 sum, mean and p50 of the int64
latency) from PxL text, its launches (C1 with the LUT opcode over the UPID
codes, K1 count, int64 and float64 sums, K2, F2) held against a numpy
oracle of its own (keys, counts and int64 sums exactly, means to rtol
1e-12, p50 in the oracle's sketch bin or the next), stream and warm
medians and the host time of the two ctx LUTs; C1 on that chain at a
16M-row feed against its plain interpreter (a kernel row); an epoch change
(32 pods recreated under another service, a service renamed) whose next
warm query groups by the new snapshot against the oracle, moving 0 column
bytes and uploading one LUT; the query through a 4-agent LocalCluster (2^22
rows an agent, each of its node's UPIDs; M1 once a query) and the UDTFs
GetAgentStatus, GetTables, GetSchemas and GetUDFList (135 names) with
px.asid() and px.node_name() through it; seq_gen and the process and
network stats connectors on the Collector's thread while 50 warm queries
run over seq0 (counts never decrease, each sum that of a prefix); 2^22
http_events rows replayed with time rewritten, then the ctx query over them
against the oracle; and the profiler's stack_traces.beta with native frames
of the interpreter symbolized through ElfReader, grouped by stack on the
card.

It prints one JSON line per kernel, a {"kernels": [...]} line, the card's
name and power limit, and last {"ok": true, "device": {...}}.  It exits
non-zero, printing no result, without a CUDA device or outside the repo.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEC = 1_000_000_000
N_SERVICES = 16
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
FEED = 1 << 24
#: http_events rows of the slice phase: bench's headline size, 4 full feeds
ROWS = 1 << 26
#: the sketch's parameters (LogHistogram defaults), for the oracle
GAMMA, MIN_VALUE, WIDTH = 1.0404, 1e-9, 514
#: bench's device-join shape (bench.py bench_device_join): 16M x 16M codes
JOIN_ROWS = 1 << 24
#: config #3's network_stats rows (bench_config3 at 16M) and the executor
#: device join's rows per side
CONFIG3_ROWS = 1 << 24
EXEC_JOIN_ROWS = 1 << 22
#: (library, C entry point) of the kernels each slice phase must launch
C1 = ("chain", "px_chain_run")
K3 = ("loghist_quantile", "px_loghist_quantile")
#: the device finalize: F1 a single-feed aggregate's one launch, F2 the
#: merge + finalize after the per-feed route, P1 a raw state's pack
F1 = ("finalize", "px_fused_partial_finalize")
F2 = ("finalize", "px_merge_finalize")
P1 = ("pack", "px_state_pack")
#: the device merge of partial states across agents or shards
M1 = ("merge", "px_merge_states")
#: config #1 over 4 feeds: the per-feed route, then F2 (no K3)
CONFIG1_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                   ("segment_reduce", "px_segment_sum_f64"),
                   ("loghist_update", "px_loghist_update"), F2,
                   ("resident", "px_resident_fold")]
SELECT_KERNELS = [C1, ("compact", "px_compact"), ("resident", "px_resident_fold")]
#: config #3: both aggregates are one feed (F1); the pods scan is a select
CONFIG3_KERNELS = [C1, F1, ("compact", "px_compact"), ("resident", "px_resident_fold")]
JOIN_KERNELS = [C1, ("compact", "px_compact"), ("join", "px_join_build"),
                ("join", "px_join_probe"), ("join", "px_join_expand")]
#: config #2 runs the whole aggregate path (4 feeds, then F2); config #5
#: and the cluster stream finalize on the host (finalize_partial)
CONFIG2_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                   ("segment_reduce", "px_segment_sum_f64"),
                   ("loghist_update", "px_loghist_update"), F2]
CONFIG5_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                   ("loghist_update", "px_loghist_update")]
CLUSTER_STREAM_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                          ("segment_reduce", "px_segment_sum_f64"),
                          ("loghist_update", "px_loghist_update")]
#: the resident phase's queries are one feed each: F1
RESIDENT_KERNELS = [("resident", "px_resident_fold"), ("resident", "px_resident_move"), F1]
#: config #4's agents keep raw partial state (no finalize): M1 merges it
#: into one packed buffer, read back in one copy with no P1 launch; the
#: mixed-dictionary run reads each agent's state back through P1
CONFIG4_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                   ("segment_reduce", "px_segment_sum_f64"),
                   ("loghist_update", "px_loghist_update"),
                   ("merge", "px_merge_states"), ("resident", "px_resident_fold")]
MIXED_KERNELS = [C1, P1]
SORTED_KERNELS = [("segment_reduce", e) for e in (
    "px_segment_count", "px_segment_sum_i64", "px_segment_sum_f64",
    "px_segment_min_f64", "px_segment_max_f64")] + [("loghist_update", "px_loghist_update"), K3]
#: resident phase: an 8M-row table (one feed) and the rows appended to it
RESIDENT_ROWS = 1 << 23
RESIDENT_APPEND = 1 << 20
#: sorted phase rows, conn_id range and bytes range (4096 bins of 4096)
SORTED_ROWS = 1 << 24
CONN_IDS = 1 << 23
BYTES_RANGE = 1 << 24
#: the agg's pruned feed of config #1: service (int32) + latency + status
CONFIG1_ROW_BYTES = 4 + 8 + 8
#: config #4 (bench_config4 at its default --dist-rows): 8 agent stores of 2M
#: rows each; the mixed-dictionary run: 8 stores of 1M rows
CONFIG4_AGENTS = 8
CONFIG4_ROWS = 1 << 24
MIXED_ROWS = 1 << 20
#: bench.py bench_config4's script, verbatim
CONFIG4_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn(): time.perf_counter over `calls`
    calls with no synchronize between them (the launch path alone while the
    card runs behind it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (every NaN counted as one value)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        if not torch.equal(a.isnan(), b.isnan()):
            return False
        ints = torch.int32 if a.element_size() == 4 else torch.int64
        a = torch.where(a.isnan(), torch.zeros_like(a), a).view(ints)
        b = torch.where(b.isnan(), torch.zeros_like(b), b).view(ints)
    return torch.equal(a, b)


def state_tree(state):
    """A merged state as its tree (a Packed's leaves as views of its buffer)."""
    from pixie_tpu_torch.ops import pack as p1

    return state.tree() if isinstance(state, p1.Packed) else state


#: M1 past one launch's parameter block: 17 states over 250 leaves (rows of
#: 20 words, 203 a launch: two launches)
M1_PAST_STATES, M1_PAST_LEAVES = 17, 250
#: P1 past one launch's table: 2,000 leaves (1,024 a launch: two launches)
P1_PAST_LEAVES = 2000


def m1_past_capacity(dev, merge, label: str) -> dict:
    """`merge` (M1 or the collective merge) over M1_PAST_STATES states of
    M1_PAST_LEAVES leaves of four dtypes and ragged sizes (int64 sums that
    wrap, NaN through min and max) on the card: the table splits into the
    plan's launches (at least two), and the result equals the plain version
    bit for bit; → its detail."""
    import torch

    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.ops import merge as m1
    from pixie_tpu_torch.ops import pack as p1

    rng = np.random.default_rng(18)
    rt = {f"l{i}": ("add", "min", "max")[i % 3] for i in range(M1_PAST_LEAVES)}

    def leaf(i):
        n = 1 + (i * 37) % 300
        if i % 4 == 1:
            return rng.integers(2 ** 62, 2 ** 63 - 1, n, dtype=np.int64)
        if i % 4 == 3:
            return rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32)
        v = rng.normal(size=n).astype(np.float64 if i % 4 == 0 else np.float32)
        v[rng.integers(0, n)] = np.nan
        return v

    sts = [{k: torch.from_numpy(leaf(i)).to(dev) for i, k in enumerate(rt)}
           for _ in range(M1_PAST_STATES)]
    want_launches = len(m1.plan_for(rt, sts).launches)
    before = _build.KERNELS["merge"].launches
    got = merge(rt, sts)
    torch.cuda.synchronize()
    launches = _build.KERNELS["merge"].launches - before
    if want_launches < 2 or launches != want_launches:
        raise AssertionError(f"M1 {label}: {launches} launches, want {want_launches} (>= 2)")
    want = m1.merge_states_plain(rt, sts)
    for (path, a), (_p, b) in zip(p1.flatten(state_tree(got)), p1.flatten(want)):
        if not same_bits(a, b):
            raise AssertionError(f"M1 {label}: leaf {path} differs from the plain version")
    out = {"states": M1_PAST_STATES, "leaves": M1_PAST_LEAVES, "launches": launches,
           "host_us": host_us(lambda: merge(rt, sts))}
    log(json.dumps({"check": f"M1 {label}", "ok": True, "max_abs_err": 0.0, **out}))
    return out


def read_launches(phase: str, required) -> dict:
    """Launches since the last reset, by library and C entry point; raises if
    a kernel the phase must run did not launch."""
    from pixie_tpu_torch.ops import _build

    launches = {name: dict(k.by_entry) for name, k in _build.KERNELS.items()}
    missing = [f"{lib}.{e}" for lib, e in required if launches[lib].get(e, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {phase} path: {missing}")
    return launches


def warm_times(query, warmup: int = 2, reps: int = 5) -> list[float]:
    """Sorted wall seconds of `reps` runs of query() after `warmup` runs."""
    for _ in range(warmup):
        query()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        query()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def _build_fn(lib: str, symbol: str, n_int_args: int):
    """A kernel library's C entry point that takes n int arguments."""
    import ctypes

    from pixie_tpu_torch.ops import _build

    return _build.function(lib, symbol, [ctypes.c_int] * n_int_args)


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    b_ms, o_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# ------------------------------------------------------------ kernel checks


def check_kernels(dev) -> list[dict]:
    """Hold K1-K3 against their plain versions; returns the kernel rows
    (each names its C entry point, whose main-path launches fill in later)."""
    import torch

    from pixie_tpu_torch.ops import groupby as gb
    from pixie_tpu_torch.ops.sketch import LogHistogram, update_regime

    rng = np.random.default_rng(7)
    rows = []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(kind, got, want, rtol=0.0, scale=None):
        """Exact equality, or for float64 sums |got - want| <= rtol * scale,
        where scale is each group's sum of |values| (a sum's rounding error
        in any order is relative to that, not to a sum near zero)."""
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if rtol:
            s_ = np.abs(w) if scale is None else scale.cpu().numpy()
            both_nan = np.isnan(g) & np.isnan(w)
            ok = bool(np.all(both_nan | (np.abs(g - w) <= rtol * s_)))
            d = np.abs(g - w)[~both_nan]
            err = float(d.max()) if d.size else 0.0
        else:
            ok = np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
            err = 0.0 if ok else float(np.nanmax(np.abs(g.astype(np.float64)
                                                         - w.astype(np.float64))))
        if not ok:
            raise AssertionError(f"{kind}: kernel and plain version disagree "
                                 f"(max abs err {err})")
        return err

    def k1(op, v, gid, mask, g, out0):
        a, b = out0.clone(), out0.clone()
        scale = None
        if op == "count":
            gb.masked_segment_count(gid, g, mask, out=a)
            gb.segment_count_plain(gid, g, mask, b)
        elif op == "sum":
            gb.masked_segment_sum(v, gid, g, mask, out=a)
            gb.segment_sum_plain(v, gid, g, mask, b)
            if v.dtype == torch.float64:
                scale = gb.segment_sum_plain(v.abs(), gid, g, mask, torch.zeros_like(b))
        else:
            getattr(gb, f"masked_segment_{op}")(v, gid, g, mask, out=a)
            gb.segment_pick_plain(v, gid, g, mask, b, op)
        return a, b, scale

    # ---- K1 edge cases (exactness of every variant and of the global path)
    n = 1 << 20
    wrap = rng.integers(2 ** 62, 2 ** 63 - 1, n, dtype=np.int64) * np.where(
        rng.random(n) < 0.5, -1, 1)
    f64 = rng.exponential(50.0, n)
    f64[rng.random(n) < 1e-4] = np.nan
    edge_cases = [
        ("sum i64 near +-2^63 (wraps)", "sum", wrap, 64, torch.int64, 0.0),
        ("sum f64", "sum", rng.normal(0, 1e3, n), 64, torch.float64, 1e-12),
        ("sum f32 integer-valued", "sum", rng.integers(-100, 100, n).astype(np.float32),
         64, torch.float32, 0.0),
        ("min f64 with NaN", "min", f64, 64, torch.float64, 0.0),
        ("max f64 with NaN", "max", f64, 64, torch.float64, 0.0),
        ("min i64", "min", wrap, 64, torch.int64, 0.0),
        ("max i32", "max", rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32), 64,
         torch.int32, 0.0),
        ("min f32", "min", rng.normal(0, 1, n).astype(np.float32), 64, torch.float32, 0.0),
        ("count G=1", "count", None, 1, torch.int64, 0.0),
        ("count G=2^14 (opt-in shared memory)", "count", None, 1 << 14, torch.int64, 0.0),
        ("sum f64 G=5000", "sum", rng.normal(0, 1, n), 5000, torch.float64, 1e-12),
        ("sum f64 G=1", "sum", f64, 1, torch.float64, 1e-12),
        ("count G=2^16 (global atomics)", "count", None, 1 << 16, torch.int64, 0.0),
        ("sum f64 G=2^15 (global atomics)", "sum", rng.normal(0, 1, n), 1 << 15,
         torch.float64, 1e-12),
        ("max f64 G=2^15 (global atomics)", "max", f64, 1 << 15, torch.float64, 0.0),
        ("sum i64 G=2^15 (global atomics)", "sum", wrap, 1 << 15, torch.int64, 0.0),
    ]
    for label, op, vals, g, dt, rtol in edge_cases:
        gid = t(rng.integers(0, g, n).astype(np.int32))
        for mask_label, m in (("", rng.random(n) < 0.9), (", all-false mask", np.zeros(n, bool))):
            mask = t(m)
            v = t(vals) if vals is not None else None
            if op in ("min", "max"):
                out0 = torch.full((g,), gb._identity_for(dt, op), dtype=dt, device=dev)
            else:
                out0 = torch.zeros(g, dtype=dt, device=dev)
            a, b, scale = k1(op, v, gid, mask, g, out0)
            torch.cuda.synchronize()
            err = same(label + mask_label, a, b, rtol, scale)
            log(json.dumps({"check": "K1 " + label + mask_label, "ok": True,
                            "max_abs_err": err}))

    # ---- K1 at the main path's shapes: one 16M-row feed, G = 64
    g = 64
    gid = t(rng.integers(0, g, FEED).astype(np.int32))
    mask = t(rng.random(FEED) < 0.95)
    lat = t(rng.exponential(50.0, FEED))
    gid64, mask64 = gid.long(), mask.long()
    lat_masked = torch.where(mask, lat, 0.0)
    for op, v, dt, entry, rtol in (("count", None, torch.int64, "px_segment_count", 0.0),
                                   ("sum", lat, torch.float64, "px_segment_sum_f64", 1e-12)):
        out0 = torch.zeros(g, dtype=dt, device=dev)
        a, b, scale = k1(op, v, gid, mask, g, out0)
        torch.cuda.synchronize()
        err = same(f"{op} main", a, b, rtol, scale)
        acc = torch.zeros(g, dtype=dt, device=dev)
        if op == "count":
            kern = lambda: gb.masked_segment_count(gid, g, mask, out=acc)  # noqa: E731
            plain = lambda: gb.segment_count_plain(gid, g, mask, acc)  # noqa: E731
            lib = lambda: acc.index_add_(0, gid64, mask64)  # noqa: E731
            nbytes = FEED * (4 + 1) + 2 * g * 8
        else:
            kern = lambda: gb.masked_segment_sum(lat, gid, g, mask, out=acc)  # noqa: E731
            plain = lambda: gb.segment_sum_plain(lat, gid, g, mask, acc)  # noqa: E731
            lib = lambda: acc.index_add_(0, gid64, lat_masked)  # noqa: E731
            nbytes = FEED * (4 + 1 + 8) + 2 * g * 8
        b_ms, by = bound(nbytes, FEED if op == "sum" else 0)
        rows.append({
            "name": f"segment_reduce.{op}" + ("_f64" if op == "sum" else ""),
            "route": "cuda", "source": "pixie_tpu_torch/csrc/segment_reduce.cu",
            "replaces": ("pixie_tpu/ops/groupby.py:177 masked_segment_count"
                         if op == "count" else
                         "pixie_tpu/ops/groupby.py:136 masked_segment_sum"),
            "entry": ("segment_reduce", entry), "path": "config1",
            "max_abs_err": err,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": cuda_ms(lib, 10),
            "shape": {"rows": FEED, "groups": g},
        })

    # ---- K2: bin edges, the zero bin, special values, both memory paths
    lh = LogHistogram()
    W = lh.width
    k = np.arange(-530, 530, dtype=np.float64)
    edges = np.power(lh.gamma, k)
    special = np.array([0.0, -1.0, 1e-9, np.nextafter(1e-9, 1.0), 5e-324, 1.0, np.inf,
                        -np.inf, np.nan, 1e300, 3.4e38, 3.5e38])
    edge_vals = np.concatenate([edges, np.nextafter(edges, 0.0),
                                np.nextafter(edges, np.inf), special])
    for label, g_, nv in (("bin edges G=64", 64, None), ("bin edges G=1", 1, None),
                          ("G=512 (global atomics)", 512, 1 << 20)):
        vals = (np.resize(edge_vals, 1 << 18) if nv is None
                else np.concatenate([rng.exponential(50.0, nv), edge_vals]))
        m = len(vals)
        gid_e = t(rng.integers(0, g_, m).astype(np.int32))
        v_e = t(rng.permutation(vals))
        for mask_label, mm in (("", rng.random(m) < 0.9), (", all-false mask", np.zeros(m, bool))):
            mask_e = t(mm)
            a, b = lh.init(g_, dev), lh.init(g_, dev)
            lh.update(a, gid_e, v_e, mask_e, g_)
            lh.update_plain(b, gid_e, v_e, mask_e, g_)
            torch.cuda.synchronize()
            err = same("K2 " + label + mask_label, a, b)
            log(json.dumps({"check": "K2 " + label + mask_label, "ok": True,
                            "max_abs_err": err}))
    # the regime of each group count (csrc/loghist_update.cu) as the wrapper's
    # mirror gives it at the card's opt-in shared memory
    regime = _build_fn("loghist_update", "px_loghist_regime", 2)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    regimes = {g_: regime(g_, W) for g_ in (1, 64, 113, 114, 512, 1024)}
    if any(c != update_regime(g_, W, optin) for g_, c in regimes.items()):
        raise AssertionError(f"K2 regimes {regimes} differ from ops/sketch.py update_regime")
    log(json.dumps({"check": "K2 regimes (blocks holding the sketch; 0 global)", "ok": True,
                    "optin": optin, "regimes": regimes}))
    # a feed 20% NaN at both NaN bins (0 a streaming poll's, 1 a batch
    # query's), in both regimes: one block (1, 64, 113 groups) and global
    # atomics (114, 1,024, 2,000); at 1,024 groups also with its inputs one
    # value past alignment (the one-row loads)
    vals = rng.exponential(50.0, (1 << 20) + 1)
    vals[rng.random((1 << 20) + 1) < 0.2] = np.nan
    v_all, mask_all = t(vals), t(rng.random((1 << 20) + 1) < 0.9)
    for g_ in (1, 64, 113, 114, 1024, 2000):
        gid_all = t(rng.integers(0, g_, (1 << 20) + 1).astype(np.int32))
        for nan_bin in (0, 1):
            for off in ((0, 1) if g_ == 1024 else (0,)):
                v_n, gid_n, mask_n = v_all[off:], gid_all[off:], mask_all[off:]
                a, b = lh.init(g_, dev), lh.init(g_, dev)
                lh.update(a, gid_n, v_n, mask_n, g_, nan_bin)
                lh.update_plain(b, gid_n, v_n, mask_n, g_, nan_bin)
                torch.cuda.synchronize()
                err = same(f"K2 G={g_} NaN bin {nan_bin} offset {off}", a, b)
                log(json.dumps({"check": f"K2 20% NaN, G={g_}, NaN bin {nan_bin}, "
                                         f"offset {off}", "ok": True,
                                "blocks": update_regime(g_, W, optin), "max_abs_err": err}))
    # main shapes
    a, b = lh.init(g, dev), lh.init(g, dev)
    lh.update(a, gid, lat, mask, g)
    lh.update_plain(b, gid, lat, mask, g)
    torch.cuda.synchronize()
    err = same("K2 main", a, b)
    acc = lh.init(g, dev)
    cell = gid64 * W + lh.bin_index(lat)
    weights = mask.float()
    rows.append({
        "name": "loghist_update", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/loghist_update.cu",
        "replaces": "pixie_tpu/ops/sketch.py:118 LogHistogram.update (+ bin_index :101)",
        "entry": ("loghist_update", "px_loghist_update"), "path": "config1",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lh.update(acc, gid, lat, mask, g), 20),
        "plain_ms": cuda_ms(lambda: lh.update_plain(acc, gid, lat, mask, g), 5),
        "bound_ms": bound(FEED * 13 + 2 * g * W * 4, 2 * FEED)[0],
        "bound_by": bound(FEED * 13 + 2 * g * W * 4, 2 * FEED)[1],
        # nearest single call: a weighted bincount of the precomputed cells
        "library_ms": cuda_ms(lambda: torch.bincount(cell, weights=weights,
                                                     minlength=g * W), 10),
        "shape": {"rows": FEED, "groups": g, "bins": W,
                  "blocks": update_regime(g, W, optin),
                  "device_ms": kernel_device_ms(lambda: lh.update(acc, gid, lat, mask, g), 20),
                  "host_us": host_us(lambda: lh.update(acc, gid, lat, mask, g))},
    })

    # ---- K3: exact against its plain version and the host finalize, incl.
    # empty groups, G = 1 and 17 quantiles (two launches)
    qs = [0.0, 0.01, 0.5, 0.9, 0.99, 1.0]
    for label, g_, qs_ in (("G=64", 64, qs), ("G=1", 1, qs), ("G=4096", 4096, qs),
                           ("G=4096 nq=17", 4096, np.linspace(0.0, 1.0, 17).tolist())):
        h = torch.from_numpy(rng.poisson(3.0, (g_, W)).astype(np.float32)).to(dev)
        h[g_ // 2] = 0  # an empty group → NaN
        got, want = lh.quantile_device(h, qs_), lh.quantile_plain(h, qs_)
        torch.cuda.synchronize()
        same("K3 " + label, got, want)
        host = lh.quantile(h.cpu().numpy(), qs_)
        same("K3 vs host " + label, got, torch.from_numpy(host))
        log(json.dumps({"check": "K3 " + label, "ok": True, "quantiles": len(qs_),
                        "max_abs_err": 0.0}))
    got, want = lh.quantile_device(a, [0.5]), lh.quantile_plain(a, [0.5])
    torch.cuda.synchronize()
    err = same("K3 main", got, want)
    # S2's shape: bin(bytes, 4096) gives 4,096 groups of about 4,096 rows
    s2 = torch.from_numpy(rng.poisson(8.0, (4096, W)).astype(np.float32)).to(dev)
    same("K3 at S2's shape", lh.quantile_device(s2, [0.5]), lh.quantile_plain(s2, [0.5]))
    k3 = {}
    for label, hist in (("G=64", a), ("S2 G=4096", s2)):
        g_ = hist.shape[0]
        b_ms, by = bound(g_ * W * 4 + 4 + W * 8 + g_ * 8)

        def kern(hist=hist):
            return lh.quantile_device(hist, [0.5])

        k3[label] = {"groups": g_, "ms": cuda_ms(kern, 50),
                     "device_ms": kernel_device_ms(kern, 50), "host_us": host_us(kern),
                     "plain_ms": cuda_ms(lambda hist=hist: lh.quantile_plain(hist, [0.5]), 20),
                     "bound_ms": b_ms, "bound_by": by}
    # a warm call uploads nothing: the bin values are cached on the card and
    # the quantiles travel in the launch's parameters
    copies = h2d_copies(lambda: lh.quantile_device(a, list(qs)))
    if copies["h2d_per_call"] != 0 or copies["device_events_per_call"] == 0:
        raise AssertionError(f"K3: a warm call's profile {copies}, want 0 H2D copies beside "
                             "its kernel")
    log(json.dumps({"kernel_detail": "loghist_quantile", **k3, "warm_call": copies}))
    rows.append({
        "name": "loghist_quantile", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/loghist_quantile.cu",
        "replaces": "pixie_tpu/ops/sketch.py:257 LogHistogram.quantile_device",
        "entry": ("loghist_quantile", "px_loghist_quantile"), "path": "sorted",
        "max_abs_err": err,
        **{k: k3["G=64"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shape": {"groups": g, "bins": W, "quantiles": 1, "device_ms": k3["G=64"]["device_ms"],
                  "host_us": k3["G=64"]["host_us"], "s2": k3["S2 G=4096"],
                  "warm_h2d_per_call": copies["h2d_per_call"]},
    })
    return rows


def j1_hold(label: str, b, K: int) -> dict:
    """J1 on the card against its plain version on the same codes: cnt,
    first and rows_by_code[:sum(cnt)] equal exactly, and a second call gives
    the same bits; → the sort's passes and the rows kept."""
    import torch

    from pixie_tpu_torch.ops import join_device as jd

    got = jd.join_build(b, K)
    again = jd.join_build(b, K)
    cnt0, first0, rows0 = jd.join_build_plain(b, K)
    torch.cuda.synchronize()
    m = rows0.shape[0]
    for (name, x, y) in (("cnt", got[0], cnt0), ("first", got[1], first0),
                         ("rows_by_code", got[2][:m], rows0)):
        if not torch.equal(x, y):
            raise AssertionError(f"J1 {label}: {name} differs from the plain version")
    if not all(torch.equal(x[:m] if i == 2 else x, y[:m] if i == 2 else y)
               for i, (x, y) in enumerate(zip(got, again))):
        raise AssertionError(f"J1 {label}: two calls differ")
    return {"passes": jd._build_plan(b.shape[0], K)[2], "rows": m}


def j1_timed(b, K: int) -> dict:
    """J1's times at one shape: CUDA events, device time, host microseconds
    a call, its plain version, and its bound (the codes read once; cnt,
    first and the valid rows written once)."""
    from pixie_tpu_torch.ops import join_device as jd

    n = b.shape[0]
    b_ms, by = bound(n * 8 + K * 4 * 2 + n * 4)
    return {"build": n, "K": K, "ms": cuda_ms(lambda: jd.join_build(b, K), 10),
            "device_ms": kernel_device_ms(lambda: jd.join_build(b, K), 10),
            "host_us": host_us(lambda: jd.join_build(b, K), 50),
            "plain_ms": cuda_ms(lambda: jd.join_build_plain(b, K), 3, 1),
            "bound_ms": b_ms, "bound_by": by}


#: J1's timed shapes beside bench's 16M x 16M: the device join phase's
#: build side (2^22 rows, codes in [0, 2^20)) and the 16M codes with one
#: code holding half the rows
J1_PHASE_ROWS, J1_PHASE_KEYS = 1 << 22, 1 << 20


def j1_shapes(dev, b, K: int, rng) -> dict:
    """J1 held and timed at bench's shape (`b`, K), at the device join
    phase's and with half the rows on one code; → their details."""
    import torch

    out = {"uniform": {**j1_hold("16M uniform", b, K), **j1_timed(b, K)}}
    bh = rng.integers(0, J1_PHASE_KEYS, J1_PHASE_ROWS).astype(np.int64)
    ph = torch.from_numpy(bh).to(dev)
    out["phase"] = {**j1_hold("the join phase's shape", ph, J1_PHASE_KEYS),
                    **j1_timed(ph, J1_PHASE_KEYS)}
    half = b.clone()
    half[torch.from_numpy(rng.random(b.shape[0]) < 0.5).to(dev)] = 777
    out["half_one_code"] = {**j1_hold("half the rows one code", half, K),
                            **j1_timed(half, K)}
    log(json.dumps({"kernel_detail": "join.build", **out}))
    return out


def j3_timed(dev, label: str, bh, ph) -> dict:
    """J3 held in order against its plain version on J1's and J2's outputs
    for build codes bh and probe codes ph (numpy), given J2's tiles as the
    main path gives them and counting its own, then timed as the main path
    runs it: CUDA events, device time, host microseconds a call, its plain
    version, and its bound (each probe row's count and lo read once, each
    matched build row's entry of rows_by_code read once, the pairs and
    build_matched written once)."""
    import torch

    from pixie_tpu_torch.ops import join_device as jd

    b, p, K = jd._dense(torch.from_numpy(bh.astype(np.int64)).to(dev),
                        torch.from_numpy(ph.astype(np.int64)).to(dev))
    cnt, first, rbc = jd.join_build(b, K)
    cnt_p, lo_p, total, tiles = jd.join_probe(p, cnt, first, tiles=True)
    total = int(total)
    nb, npr = b.shape[0], p.shape[0]
    got = jd.join_expand(cnt_p, lo_p, rbc, nb, total, tiles)
    alone = jd.join_expand(cnt_p, lo_p, rbc, nb, total)
    want = jd.join_expand_plain(cnt_p, lo_p, rbc, nb, total)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) and torch.equal(x, w) for g, x, w in zip(got, alone, want)):
        raise AssertionError(f"J3 {label}: kernel (with and without J2's tiles) and plain "
                             "version disagree (in order)")
    matched = int(got[2].sum())
    # probe_matched is J2's since J2 gives J3 its tiles
    b_ms, by = bound(npr * 8 + matched * 4 + total * 16 + nb)
    del got, alone, want

    def kern():
        return jd.join_expand(cnt_p, lo_p, rbc, nb, total, tiles)

    return {"build": nb, "probe": npr, "K": K, "pairs": total, "ms": cuda_ms(kern, 10),
            "device_ms": kernel_device_ms(kern, 10), "host_us": host_us(kern, 50),
            "plain_ms": cuda_ms(lambda: jd.join_expand_plain(cnt_p, lo_p, rbc, nb, total), 3, 1),
            "bound_ms": b_ms, "bound_by": by}


def j3_shapes(dev) -> dict:
    """J3 held and timed at the device join phase's shape (2^22 x 2^22
    codes in [0, 2^20): about 4 pairs a probe row) and at the heavy key
    (4,096 rows a side on one key over 2^20 background rows: 16M pairs
    from 4,096 probe rows); → their details."""
    rng = np.random.default_rng(12)
    n = J1_PHASE_ROWS
    out = {"phase": j3_timed(dev, "the join phase's shape", rng.integers(0, J1_PHASE_KEYS, n),
                             rng.integers(0, J1_PHASE_KEYS, n))}
    bg = rng.integers(100, 1 << 22, 1 << 20)
    out["heavy_key"] = j3_timed(dev, "one key, 4096 rows a side",
                                np.concatenate([np.full(4096, 7), bg]),
                                np.concatenate([np.full(4096, 7), bg[::-1]]))
    log(json.dumps({"kernel_detail": "join.expand", **out}))
    return out


def same_values(a, b) -> bool:
    """Equal dtype and shape, NaN in the same places, equal values elsewhere
    (-0.0 equal to +0.0: which of the two a min / max keeps is unspecified)."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


#: the NaN that K1 writes where a row brings one (csrc/segment_reduce.cu):
#: a min state's is the negative quiet NaN, a max state's the positive one
K1_NAN_BITS = {("f64", "min"): -(1 << 51), ("f64", "max"): 0x7FF8 << 48,
               ("f32", "min"): -(1 << 22), ("f32", "max"): 0x7FC00000}


def k1_nan_states(dev, gid, mask, lat, g: int, label: str, rng) -> None:
    """K1 f64 and f32 min / max on one shape's ids: the values 1% NaN with
    +-0.0 and +-inf, into a state that enters holding the positive NaN in
    its first eighth of groups and the negative NaN in its second, against
    the plain version (NaN as NaN).  Every entering NaN stays with its bits;
    a NaN a row brings is the op's own NaN."""
    import torch

    from pixie_tpu_torch.ops import groupby as gb

    n = gid.shape[0]
    nan_rows = torch.from_numpy(rng.random(n) < 0.01).to(dev)
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf")], dtype=torch.float64,
                            device=dev)
    at = torch.from_numpy(rng.integers(0, n, 4096)).to(dev)
    v64 = torch.where(nan_rows, float("nan"), lat)
    v64[at] = specials.repeat(1024)
    for name, v, ints, pos in (("f64", v64, torch.int64, 0x7FF8 << 48),
                               ("f32", v64.float(), torch.int32, 0x7FC00000)):
        for op in ("min", "max"):
            state = torch.full((g,), gb._identity_for(v.dtype, op), dtype=v.dtype, device=dev)
            state.view(ints)[: g // 8] = pos
            state.view(ints)[g // 8: g // 4] = K1_NAN_BITS[(name, "min")]
            entered, entered_bits = state.isnan(), state.view(ints).clone()
            want = state.clone()
            getattr(gb, f"masked_segment_{op}")(v, gid, g, mask, out=state)
            gb.segment_pick_plain(v, gid, g, mask, want, op)
            torch.cuda.synchronize()
            from_rows = state.isnan() & ~entered
            ok = (same_values(state, want)
                  and torch.equal(state.view(ints)[entered], entered_bits[entered])
                  and bool((state.view(ints)[from_rows] == K1_NAN_BITS[(name, op)]).all()))
            if not ok:
                raise AssertionError(f"K1 {op} {name} at {label}: NaN states differ from the "
                                     "plain version or lost their NaN")
            log(json.dumps({"check": f"K1 {op} {name} at {label} with NaN states", "ok": True,
                            "groups": g, "entered_nan": int(entered.sum()),
                            "nan_from_rows": int(from_rows.sum()), "max_abs_err": 0.0}))
    del v64, nan_rows, at


def k1_sorted_adds(dev, gid, mask, lat, g: int, touched: int, rng) -> dict:
    """K1 count, int64 sum and f64 sum at the sorted chunk's shape (S1's
    other leaves), each held against its plain version (counts and int64
    sums exactly, f64 sums to 1e-12 of each group's sum of |values|) and
    timed: CUDA events, device time, host microseconds a call, its plain
    version, index_add_ and its bound (each row's id, mask and value read
    once, each touched group's state read and written once)."""
    import torch

    from pixie_tpu_torch.ops import groupby as gb

    n = gid.shape[0]
    nbytes = torch.from_numpy(rng.integers(0, 1 << 24, n)).to(dev)
    gid64 = gid.long()
    out = {}
    for op, v, dt in (("count", None, torch.int64), ("sum_i64", nbytes, torch.int64),
                      ("sum_f64", lat, torch.float64)):
        got, want, acc = (torch.zeros(g, dtype=dt, device=dev) for _ in range(3))
        if v is None:
            def kern(acc=acc):
                return gb.masked_segment_count(gid, g, mask, out=acc)

            def plain(acc=acc):
                return gb.segment_count_plain(gid, g, mask, acc)

            addend = mask.long()
            gb.masked_segment_count(gid, g, mask, out=got)
            gb.segment_count_plain(gid, g, mask, want)
        else:
            def kern(acc=acc, v=v):
                return gb.masked_segment_sum(v, gid, g, mask, out=acc)

            def plain(acc=acc, v=v):
                return gb.segment_sum_plain(v, gid, g, mask, acc)

            addend = torch.where(mask, v, 0)
            gb.masked_segment_sum(v, gid, g, mask, out=got)
            gb.segment_sum_plain(v, gid, g, mask, want)
        torch.cuda.synchronize()
        if dt == torch.float64:
            scale = gb.segment_sum_plain(v.abs(), gid, g, mask, torch.zeros_like(want))
            err = float((got - want).abs().max())
            ok = bool(((got - want).abs() <= 1e-12 * scale).all())
        else:
            err, ok = 0.0, torch.equal(got, want)
        if not ok:
            raise AssertionError(f"K1 {op} at the sorted chunk: kernel and plain version "
                                 "disagree")
        b_ms, by = bound(n * (4 + 1 + (0 if v is None else 8)) + 2 * touched * 8,
                         n if dt == torch.float64 else 0)
        out[op] = {"max_abs_err": err, "ms": cuda_ms(kern, 20),
                   "device_ms": kernel_device_ms(kern, 20), "host_us": host_us(kern),
                   "plain_ms": cuda_ms(plain, 5), "bound_ms": b_ms, "bound_by": by,
                   "library_ms": cuda_ms(lambda acc=acc: acc.index_add_(0, gid64, addend), 10)}
    return out


J2_PHASE_LABEL = "the device join phase's shape (2^22 x 2^22, codes in [0, 2^20))"


def j2_bytes(npr: int, slots: int) -> int:
    """J2's bytes: each probe code read once, each table slot a probe can
    touch read once (its count and first), count and lo written once,
    probe_matched, the tiles' offsets and the total written once."""
    return npr * 8 + slots * 8 + npr * 8 + npr + -(-npr // 4096) * 8 + 8


def j2_phase(dev) -> dict:
    """J2 (the join's probe) at the device join phase's shape: 2^22 build
    and 2^22 probe codes uniform in [0, 2^20) (seed 14), held exactly against
    its plain version (each probe row's count and first build row, the
    total, the tiles' offsets and probe_matched) and timed as the main path
    runs it (with its tiles): CUDA events, device time, host microseconds a
    call, its plain version and its bound; then J2 + J3 as the device join
    runs them (J3 given J2's tiles) and as two stages that each count
    (J2 without tiles, J3 with its own counts pass), summed on one
    timeline."""
    import torch

    from pixie_tpu_torch.ops import join_device as jd

    rng = np.random.default_rng(14)
    n = J1_PHASE_ROWS
    b, p, K = jd._dense(torch.from_numpy(rng.integers(0, J1_PHASE_KEYS, n)).to(dev),
                        torch.from_numpy(rng.integers(0, J1_PHASE_KEYS, n)).to(dev))
    cnt, first, rbc = jd.join_build(b, K)
    got = jd.join_probe(p, cnt, first, tiles=True)
    want = jd.join_probe_plain(p, cnt, first, tiles=True)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and int(got[2]) == int(want[2]) and torch.equal(got[3][0], want[3][0])
            and torch.equal(got[3][1], want[3][1])):
        raise AssertionError(f"J2 at {J2_PHASE_LABEL}: kernel and plain version disagree")
    total = int(got[2])
    del got, want

    def kern():
        return jd.join_probe(p, cnt, first, tiles=True)

    def fused():
        cp, lp, _t, tiles = jd.join_probe(p, cnt, first, tiles=True)
        return jd.join_expand(cp, lp, rbc, n, total, tiles)

    def unfused():
        cp, lp, _t = jd.join_probe(p, cnt, first)
        return jd.join_expand(cp, lp, rbc, n, total)

    b_ms, by = bound(j2_bytes(n, min(K, n)))
    out = {"build": n, "probe": n, "K": K, "pairs": total, "ms": cuda_ms(kern, 10),
           "device_ms": kernel_device_ms(kern, 10), "host_us": host_us(kern, 50),
           "plain_ms": cuda_ms(lambda: jd.join_probe_plain(p, cnt, first, tiles=True), 3, 1),
           "bound_ms": b_ms, "bound_by": by}
    matched = int(fused()[2].sum())
    out["j2_j3"] = {
        "ms": cuda_ms(fused, 10), "device_ms": kernel_device_ms(fused, 10),
        "host_us": host_us(fused, 50),
        "unfused_ms": cuda_ms(unfused, 10), "unfused_device_ms": kernel_device_ms(unfused, 10),
        "bound_ms": b_ms + bound(n * 8 + matched * 4 + total * 16 + n)[0]}
    log(json.dumps({"kernel_detail": "join.probe", "shape": J2_PHASE_LABEL, **out}))
    return out


def check_new_kernels(dev) -> list[dict]:
    """K1 min/max timed at the sorted path's shape; K4 and J1-J3 held
    against their plain versions.  Returns their kernel rows."""
    import torch

    from pixie_tpu_torch.ops import compact as k4
    from pixie_tpu_torch.ops import groupby as gb
    from pixie_tpu_torch.ops import join_device as jd

    rows = []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- K1 at the sorted path's shape (one 2^20-row chunk into state of
    # 2^23 groups: the global route) and at config #1's feed shape (16M
    # rows, G = 64: shared memory): min / max everywhere, count and sums at
    # the sorted chunk (S1's other leaves)
    rng = np.random.default_rng(8)
    for label, n, g in (("sorted", 1 << 20, 1 << 23), ("feed", FEED, 64)):
        gid = t(rng.integers(0, g, n).astype(np.int32))
        mask = t(rng.random(n) < 0.95)
        lat = t(rng.exponential(50.0, n))
        gid64 = gid.long()
        touched = int(torch.unique(gid[mask]).numel())
        detail = {}
        for op in ("min", "max"):
            ident = gb._identity_for(torch.float64, op)
            out0 = torch.full((g,), ident, dtype=torch.float64, device=dev)
            a, b = out0.clone(), out0.clone()
            getattr(gb, f"masked_segment_{op}")(lat, gid, g, mask, out=a)
            gb.segment_pick_plain(lat, gid, g, mask, b, op)
            torch.cuda.synchronize()
            if not same_values(a, b):
                raise AssertionError(f"K1 {op} {label}: kernel and plain version disagree")
            acc = out0.clone()
            lat_id = torch.where(mask, lat, ident)
            red = "amin" if op == "min" else "amax"

            def kern(op=op, acc=acc):
                return getattr(gb, f"masked_segment_{op}")(lat, gid, g, mask, out=acc)

            # each row's id, mask and value read once; each touched group's
            # state read and written once
            b_ms, by = bound(n * (4 + 1 + 8) + 2 * touched * 8, n)
            detail[op] = {
                "ms": cuda_ms(kern, 20), "device_ms": kernel_device_ms(kern, 20),
                "host_us": host_us(kern),
                "plain_ms": cuda_ms(lambda: gb.segment_pick_plain(lat, gid, g, mask, acc, op),
                                    5),
                "bound_ms": b_ms, "bound_by": by,
                # a random atomic moves a 32-byte sector each way
                "sector_ms": (n * (4 + 1 + 8) + 2 * touched * 32) / PEAK_BYTES * 1e3,
                "library_ms": cuda_ms(lambda: acc.scatter_reduce_(
                    0, gid64, lat_id, reduce=red, include_self=True), 10),
            }
        if label == "sorted":
            detail.update(k1_sorted_adds(dev, gid, mask, lat, g, touched, rng))
        log(json.dumps({"kernel_detail": "segment_reduce at " + label, "rows": n, "groups": g,
                        "touched": touched, **detail}))
        if label == "sorted":
            for op in ("min", "max"):
                rows.append({
                    "name": f"segment_reduce.{op}_f64", "route": "cuda",
                    "source": "pixie_tpu_torch/csrc/segment_reduce.cu",
                    "replaces": f"pixie_tpu/ops/groupby.py:{188 if op == 'min' else 194} "
                                f"masked_segment_{op}",
                    "entry": ("segment_reduce", f"px_segment_{op}_f64"), "path": "sorted_s1",
                    "max_abs_err": 0.0,
                    **{k: v for k, v in detail[op].items()
                       if k not in ("device_ms", "host_us", "sector_ms")},
                    "shape": {"rows": n, "groups": g, "touched": touched,
                              **{k: detail[op][k] for k in ("device_ms", "host_us",
                                                            "sector_ms")}},
                })
            for op, entry, replaces in (
                    ("count", "px_segment_count", "177 masked_segment_count"),
                    ("sum_i64", "px_segment_sum_i64", "136 masked_segment_sum"),
                    ("sum_f64", "px_segment_sum_f64", "136 masked_segment_sum")):
                d = detail[op]
                rows.append({
                    "name": f"segment_reduce.{op} (sorted chunk)", "route": "cuda",
                    "source": "pixie_tpu_torch/csrc/segment_reduce.cu",
                    "replaces": "pixie_tpu/ops/groupby.py:" + replaces,
                    "entry": ("segment_reduce", entry), "path": "sorted_s1",
                    **{k: v for k, v in d.items() if k not in ("device_ms", "host_us")},
                    "shape": {"rows": n, "groups": g, "touched": touched,
                              "device_ms": d["device_ms"], "host_us": d["host_us"]},
                })
        k1_nan_states(dev, gid, mask, lat, g, label, rng)
        del gid, mask, lat, gid64, acc, lat_id

    # ---- K4: 2^24 rows, 4 columns, six densities; exact and in order
    rng = np.random.default_rng(9)
    n = FEED
    cols = [t(rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)),
            t(rng.integers(-2 ** 62, 2 ** 62, n)), t(rng.normal(size=n)),
            t(rng.random(n) < 0.5)]
    width = sum(c.element_size() for c in cols)
    u = t(rng.random(n))
    timed = {}
    for density in (0.9, 0.1, 1.0, 0.0, 0.001, 0.5):
        m = u < density
        got, count = k4.compact(m, cols)
        want, want_count = k4.compact_plain(m, cols)
        torch.cuda.synchronize()
        c = int(count)
        if c != int(want_count) or not all(torch.equal(x[:c], y[:c])
                                           for x, y in zip(got, want)):
            raise AssertionError(f"K4 density {density}: kernel and plain version disagree")
        log(json.dumps({"check": f"K4 density {density}", "ok": True, "kept": c,
                        "max_abs_err": 0.0}))
        if density in (0.9, 0.1):
            b_ms, by = bound(n + 2 * c * width + 8)

            def kern(m=m):
                return k4.compact(m, cols)

            timed[density] = {
                "ms": cuda_ms(kern, 20), "device_ms": kernel_device_ms(kern, 20),
                "host_us": host_us(kern),
                "plain_ms": cuda_ms(lambda: k4.compact_plain(m, cols), 5),
                "library_ms": cuda_ms(lambda: [x[m] for x in cols], 10),
                "bound_ms": b_ms, "bound_by": by, "kept": c}
    log(json.dumps({"kernel_detail": "compact", "by_density": timed}))
    # the select phase keeps ~10% of each feed: its row is timed at 0.1
    rows.append({
        "name": "compact", "route": "cuda", "source": "pixie_tpu_torch/csrc/compact.cu",
        "replaces": "pixie_tpu/engine/executor.py:603 ChainKernel.make_output_step",
        "entry": ("compact", "px_compact"), "path": "select", "max_abs_err": 0.0,
        **{k: v for k, v in timed[0.1].items() if k not in ("kept", "device_ms", "host_us")},
        "shape": {"rows": n, "columns": "int32,int64,f64,bool", "density": 0.1,
                  **{k: timed[0.1][k] for k in ("kept", "device_ms", "host_us")},
                  "density_0.9": timed[0.9]},
    })
    del cols, u, m, got, want

    # ---- J1-J3 at bench's device-join shape, stage by stage
    rng = np.random.default_rng(11)
    nj = JOIN_ROWS
    b = t(rng.integers(0, nj, nj).astype(np.int64))
    p = t(rng.integers(0, nj, nj).astype(np.int64))
    b2, p2, K = jd._dense(b, p)
    cnt, first, rbc = jd.join_build(b2, K)
    cnt_p, lo_p, total_t, tiles = jd.join_probe(p2, cnt, first, tiles=True)
    total = int(total_t)
    bidx, pidx, bm, pm = jd.join_expand(cnt_p, lo_p, rbc, nj, total, tiles)
    alone = jd.join_expand(cnt_p, lo_p, rbc, nj, total)
    cnt0, first0, rbc0 = jd.join_build_plain(b2, K)
    cnt_p0, lo_p0, total0, tiles0 = jd.join_probe_plain(p2, cnt0, first0, tiles=True)
    bidx0, pidx0, bm0, pm0 = jd.join_expand_plain(cnt_p0, lo_p0, rbc0, nj, int(total0))
    torch.cuda.synchronize()
    checks = {
        "J1 cnt/first": torch.equal(cnt, cnt0) and torch.equal(first, first0),
        # within a code the rows come in ascending order, the plain
        # version's (a stable argsort)
        "J1 rows_by_code": torch.equal(rbc[:rbc0.shape[0]], rbc0),
        "J2 count/lo/total": (torch.equal(cnt_p, cnt_p0) and torch.equal(lo_p, lo_p0)
                              and total == int(total0)),
        "J2 tiles": torch.equal(tiles[0], tiles0[0]) and torch.equal(tiles[1], tiles0[1]),
        # J3 counting its own tiles gives what J3 given J2's gives
        "J3 without J2's tiles": all(torch.equal(x, y) for x, y in
                                     zip(alone, (bidx, pidx, bm, pm))),
        # grouped by probe row in probe-row order, ascending build rows
        # within a probe row: the plain version's order exactly
        "J3 pairs in order": torch.equal(bidx, bidx0) and torch.equal(pidx, pidx0),
        "J3 matched flags": torch.equal(bm, bm0) and torch.equal(pm, pm0),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"J1-J3 at {nj} x {nj}: kernels and plain versions disagree: {bad}")
    log(json.dumps({"check": f"J1-J3 {nj} x {nj} uniform", "ok": True, "K": K,
                    "pairs": total, "max_abs_err": 0.0}))
    hit = min(K, nj)  # table slots a probe can touch
    stages = [
        ("join.build", "px_join_build", "pixie_tpu/ops/join_device.py:136 _pack_sort",
         lambda: jd.join_build(b2, K), lambda: jd.join_build_plain(b2, K),
         nj * 8 + K * 4 * 2 + nj * 4),
        ("join.probe", "px_join_probe", "pixie_tpu/ops/join_device.py:161 _bucket_match",
         lambda: jd.join_probe(p2, cnt, first, tiles=True),
         lambda: jd.join_probe_plain(p2, cnt0, first0, tiles=True), j2_bytes(nj, hit)),
        ("join.expand", "px_join_expand",
         "pixie_tpu/ops/join_device.py:188 _bucket_expand (+ _expand :103, match_ranges :87)",
         lambda: jd.join_expand(cnt_p, lo_p, rbc, nj, total, tiles),
         lambda: jd.join_expand_plain(cnt_p0, lo_p0, rbc0, nj, total, tiles0),
         nj * 8 + int(bm0.sum()) * 4 + total * 16 + nj),
    ]
    for name, entry, replaces, kern, plain, nbytes in stages:
        b_ms, by = bound(nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": "pixie_tpu_torch/csrc/join.cu",
            "replaces": replaces, "entry": ("join", entry), "path": "device_join",
            "max_abs_err": 0.0, "ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 3, 1),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": {"build": nj, "probe": nj, "K": K, "pairs": total},
        })
    rows[-3]["shape"].update(j1_shapes(dev, b2, K, rng))
    rows[-2]["shape"].update(device_ms=kernel_device_ms(stages[1][3], 10),
                             host_us=host_us(stages[1][3], 50), phase=j2_phase(dev))
    rows[-1]["shape"].update(j3_shapes(dev))
    del cnt, first, rbc, cnt_p, lo_p, tiles, bidx, pidx, bm, pm, alone, stages
    del cnt0, first0, rbc0, cnt_p0, lo_p0, tiles0, bidx0, pidx0, bm0, pm0, b2, p2

    # ---- J1-J3 edge cases through device_join_codes, against the plain route
    def plain_join(bc, pc):
        bd, pd_, kk = jd._dense(bc, pc)
        c0, f0, r0 = jd.join_build_plain(bd, kk)
        cp, lp, tt = jd.join_probe_plain(pd_, c0, f0)
        return jd.join_expand_plain(cp, lp, r0, bc.shape[0], int(tt))

    bg = rng.integers(100, 1 << 22, 1 << 20)
    edges = {
        "one key, 4096 rows a side": (np.concatenate([np.full(4096, 7), bg]),
                                      np.concatenate([np.full(4096, 7), bg[::-1]])),
        "no matches": (rng.integers(0, 1 << 20, 1 << 20),
                       rng.integers(1 << 20, 1 << 21, 1 << 20)),
        "all-null probe codes": (rng.integers(0, 1 << 20, 1 << 20), np.full(1 << 20, -2)),
        "wide sparse codes (x 2^40)": (rng.integers(0, 1 << 20, 1 << 20) << 40,
                                       rng.integers(0, 1 << 20, 1 << 20) << 40),
    }
    for label, (bh, ph) in edges.items():
        bc, pc = t(bh.astype(np.int64)), t(ph.astype(np.int64))
        gi, gp, gbm, gpm = (t(x) for x in jd.device_join_codes(bc, pc))
        wi, wp, wbm, wpm = plain_join(bc, pc)
        ok = (gi.shape == wi.shape and torch.equal(gi, wi) and torch.equal(gp, wp)
              and torch.equal(gbm, wbm) and torch.equal(gpm, wpm))
        if not ok:
            raise AssertionError(f"J1-J3 {label}: kernels and plain route disagree")
        log(json.dumps({"check": f"J1-J3 {label}", "ok": True, "pairs": int(gi.shape[0]),
                        "max_abs_err": 0.0}))
    del b, p
    torch.cuda.empty_cache()
    return rows


def check_resident_kernels(dev) -> list[dict]:
    """R1 and R2 held against their plain versions at the resident tier's
    shapes, 4 columns (int32, int64, f64, bool; 21 B/row): a fold of 2^20
    rows at row 2^23 of 2^24-row buffers, a grow from 2^23 to 2^24 rows, a
    rebase dropping 2^20 of 2^24 rows.  Exact; returns their kernel rows."""
    import torch

    from pixie_tpu_torch.ops import resident as rk

    rng = np.random.default_rng(14)
    big, half, d = 1 << 24, 1 << 23, RESIDENT_APPEND
    dts = (np.int32, np.int64, np.float64, np.bool_)
    width = sum(np.dtype(x).itemsize for x in dts)

    def host(n, dt):
        return (rng.random(n) < 0.5) if dt is np.bool_ else rng.integers(-1000, 1000, n).astype(dt)

    def same(label, got, want, rows=None):
        if not all(torch.equal(g[:rows], w[:rows]) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: kernel and plain version disagree")
        log(json.dumps({"check": label, "ok": True, "max_abs_err": 0.0}))

    # ---- R1: the delta staged once, then one launch for the 4 columns
    parts = [[host(d // 2, x), host(d - d // 2, x)] for x in dts]
    bufs = [torch.zeros(big, dtype=torch.from_numpy(np.zeros(1, x)).dtype, device=dev)
            for x in dts]
    plain_bufs = [b.clone() for b in bufs]
    staging, offs, _ = rk.stage(parts, dev)
    views = [staging[o: o + d * b.element_size()].view(b.dtype) for o, b in zip(offs, bufs)]
    rk.fold_staged(bufs, staging, offs, d, half)
    for b, v in zip(plain_bufs, views):
        rk.fold_plain(b, v, half)
    torch.cuda.synchronize()
    same("R1 fold 2^20 rows x 4 columns at row 2^23", bufs, plain_bufs)
    # whole fold as the tier runs it: host assembly into pinned memory, one
    # H2D copy, the launch (host clock, synchronized)
    t0 = time.perf_counter()
    for _ in range(5):
        rk.fold(bufs, parts, half)
    torch.cuda.synchronize()
    fold_e2e_ms = (time.perf_counter() - t0) / 5 * 1e3
    b_ms, by = bound(2 * d * width)
    rows = [{
        "name": "resident.fold", "route": "cuda", "source": "pixie_tpu_torch/csrc/resident.cu",
        "replaces": "pixie_tpu/engine/resident.py:111 _kernels (fold: dynamic_update_slice)",
        "entry": ("resident", "px_resident_fold"), "path": "resident", "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: rk.fold_staged(bufs, staging, offs, d, half), 20),
        "plain_ms": cuda_ms(lambda: [rk.fold_plain(b, v, half) for b, v in zip(bufs, views)], 10),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": cuda_ms(lambda: [b[half: half + d].copy_(v)
                                       for b, v in zip(bufs, views)], 10),
        "shape": {"rows": d, "columns": "int32,int64,f64,bool", "at_row": half,
                  "bucket": big, "fold_with_h2d_ms": fold_e2e_ms},
    }]
    del staging, views, plain_bufs

    # ---- R2: grow 2^23 -> 2^24 and rebase (drop 2^20 of 2^24)
    srcs = [b[:half].clone() for b in bufs]
    got, want = rk.move(srcs, 0, half, big), [rk.move_plain(x, 0, half, big) for x in srcs]
    torch.cuda.synchronize()
    same("R2 grow 2^23 -> 2^24 x 4 columns", got, want)
    got = rk.move(bufs, d, big - d, big)
    want = [rk.move_plain(x, d, big - d, big) for x in bufs]
    torch.cuda.synchronize()
    same("R2 rebase dropping 2^20 of 2^24 x 4 columns", got, want)
    rolled = [torch.roll(x, -d) for x in bufs]
    same("R2 rebase vs torch.roll on [0, rows)", got, rolled, big - d)
    del got, want, rolled
    rebase = {
        "ms": cuda_ms(lambda: rk.move(bufs, d, big - d, big), 20),
        "plain_ms": cuda_ms(lambda: [rk.move_plain(x, d, big - d, big) for x in bufs], 10),
        "library_ms": cuda_ms(lambda: [torch.roll(x, -d) for x in bufs], 10),
        "bound_ms": bound((big - d + big) * width)[0], "bound_by": "bytes",
    }
    log(json.dumps({"kernel_detail": "resident.move", "rebase": rebase}))
    b_ms, by = bound((half + big) * width)
    rows.append({
        "name": "resident.move", "route": "cuda", "source": "pixie_tpu_torch/csrc/resident.cu",
        "replaces": "pixie_tpu/engine/resident.py:111 _kernels (grow: jnp.pad; shift: jnp.roll)",
        "entry": ("resident", "px_resident_move"), "path": "resident", "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: rk.move(srcs, 0, half, big), 20),
        "plain_ms": cuda_ms(lambda: [rk.move_plain(x, 0, half, big) for x in srcs], 10),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": cuda_ms(lambda: [torch.nn.functional.pad(x, (0, big - half))
                                       for x in srcs], 10),
        "shape": {"grow_rows": [half, big], "columns": "int32,int64,f64,bool",
                  "rebase": {"drop": d, "rows": big, **rebase}},
    })
    del srcs, bufs
    torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------------- slice


class HttpRows:
    """bench.build_http_table's generator (seed 12), continued across
    writes: 16 services, exponential(50) latency, status 200/404/500 at
    .85/.05/.10, written in chunks of 2^21 rows."""

    def __init__(self, table, rows: int, span_s: int = 600):
        self.table = table
        self.rng = np.random.default_rng(12)
        self.services = np.array([f"svc-{i}" for i in range(N_SERVICES)])
        self.t_step = span_s * SEC // max(rows, 1)
        self.written = 0

    def write(self, rows: int) -> None:
        end = self.written + rows
        while self.written < end:
            n = min(1 << 21, end - self.written)
            svc_idx = self.rng.integers(0, len(self.services), n)
            self.table.write({
                "time_": np.arange(self.written, self.written + n, dtype=np.int64) * self.t_step,
                "service": self.services[svc_idx],
                "latency": self.rng.exponential(50.0, n),
                "status": self.rng.choice([200, 404, 500], n, p=[0.85, 0.05, 0.10]),
            })
            self.written += n


def build_http_table(ts, rows: int, batch_rows: int = 1 << 16, max_bytes: int = 1 << 36,
                     semantic: bool = False, tablet_col: str | None = None):
    """bench.build_http_table's table, written into the port's store; →
    (table, its generator, for appends).  `semantic` declares the columns'
    semantic types (time_ ST_TIME_NS, service ST_SERVICE_NAME, latency
    ST_DURATION_NS); `tablet_col` makes it a tabletized table."""
    from pixie_tpu_torch.types import DataType as DT, Relation, SemanticType as ST

    rel = (Relation.of(("time_", DT.TIME64NS, ST.ST_TIME_NS),
                       ("service", DT.STRING, ST.ST_SERVICE_NAME),
                       ("latency", DT.FLOAT64, ST.ST_DURATION_NS), ("status", DT.INT64))
           if semantic else
           Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                       ("latency", DT.FLOAT64), ("status", DT.INT64)))
    t = ts.create("http_events", rel, batch_rows=batch_rows, max_bytes=max_bytes,
                  tablet_col=tablet_col)
    gen = HttpRows(t, rows)
    gen.write(rows)
    return t, gen


def http_plan():
    """bench.http_plan() (config #1) with the port's plan API."""
    from pixie_tpu_torch.plan import (AggExpr, AggOp, Call, Column, FilterOp,
                                      MemorySinkOp, MemorySourceOp, Plan, lit)

    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    node = p.add(FilterOp(expr=Call("not_equal", (Column("status"), lit(404)))),
                 parents=[src])
    agg = p.add(AggOp(groups=["service", "status"], values=[
        AggExpr("cnt", "count", None), AggExpr("avg_lat", "mean", "latency"),
        AggExpr("p50", "p50", "latency")]), parents=[node])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


def sketch_oracle(key, lat, ng: int):
    """Per group (dense key in [0, ng)): count, mean, the p50 sketch bin's
    value and np.median, in plain numpy that shares no code with the
    port's sketch."""
    cnt = np.bincount(key, minlength=ng)
    mean = np.bincount(key, weights=lat, minlength=ng) / np.maximum(cnt, 1)
    W = WIDTH
    x = np.maximum(lat.astype(np.float32), np.float32(MIN_VALUE))
    lg = np.log(x) / np.float32(math.log(GAMMA))
    bins = np.clip(np.ceil(lg).astype(np.int64) + 1, 0, W - 1)
    bins[lat <= MIN_VALUE] = 0
    hist = np.bincount(key * W + bins, minlength=ng * W).reshape(ng, W)
    # p50 bin: first bin whose running count reaches half the group's total
    cum = np.cumsum(hist, axis=1)
    idx = np.minimum((cum < 0.5 * cum[:, -1:]).sum(axis=1), W - 1)
    sketch_p50 = np.where(idx <= 0, 0.0, GAMMA ** (idx - 1.5))
    order = np.argsort(key, kind="stable")
    bounds = np.searchsorted(key[order], np.arange(ng + 1))
    lat_sorted = lat[order]
    median = np.array([np.median(lat_sorted[bounds[i]:bounds[i + 1]]) if cnt[i] else np.nan
                       for i in range(ng)])
    return cnt, mean, sketch_p50, median


def check_p50(p50, want_bin, median) -> tuple[int, float]:
    """p50 in the oracle's sketch bin (or the next, for a value on a bin
    edge) and within 2.1% of np.median; → (exact bins, max relative
    error)."""
    ratio = p50 / want_bin
    in_bin = ((ratio == 1.0) | np.isclose(ratio, GAMMA, rtol=1e-12)
              | np.isclose(ratio, 1 / GAMMA, rtol=1e-12))
    if not in_bin.all():
        raise AssertionError(f"p50 outside the oracle's sketch bin: {p50[~in_bin]}")
    rel_err = np.abs(p50 - median) / median
    if not (rel_err <= 0.021).all():
        raise AssertionError(f"p50 beyond 2.1% of np.median: {rel_err.max()}")
    return int((ratio == 1.0).sum()), float(rel_err.max())


def oracle_check(table, res) -> dict:
    """numpy oracle of config #1 over the table's rows; raises on mismatch."""
    cols = _table_columns(table, ("service", "latency", "status"))
    svc, lat, st = (cols[k] for k in ("service", "latency", "status"))
    sel = st != 404
    svc, lat, st = svc[sel], lat[sel], st[sel]
    statuses = np.unique(st)
    key = svc.astype(np.int64) * len(statuses) + np.searchsorted(statuses, st)
    ng = int(key.max()) + 1
    cnt, mean, sketch_p50, median = sketch_oracle(key, lat, ng)
    got_key = (res.columns["service"].astype(np.int64) * len(statuses)
               + np.searchsorted(statuses, res.columns["status"]))
    if res.num_rows != int((cnt > 0).sum()):
        raise AssertionError(f"groups: got {res.num_rows}, want {(cnt > 0).sum()}")
    if not np.array_equal(np.asarray(res.columns["cnt"]), cnt[got_key]):
        raise AssertionError("counts differ from the oracle")
    if not np.allclose(res.columns["avg_lat"], mean[got_key], rtol=1e-9, atol=0):
        raise AssertionError("means differ from the oracle beyond rtol 1e-9")
    exact, rel = check_p50(np.asarray(res.columns["p50"]), sketch_p50[got_key],
                           median[got_key])
    if not all(np.isfinite(np.asarray(res.columns[c], dtype=np.float64)).all()
               for c in ("cnt", "avg_lat", "p50")):
        raise AssertionError("non-finite results")
    return {"groups": res.num_rows, "p50_exact_bin": exact, "p50_max_rel_err_vs_median": rel}


def profile_query(query) -> dict:
    """One query under torch.profiler: device busy time (kernels and copies,
    by name) against the host wall time, and so the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # (CUDA activity alone: with CPU activity too, no device event of a query
    # that makes a cooperative launch reached key_averages())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:15]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def stream_and_warm(query, label: str, with_profile: bool = False, reps: int = 5,
                    warm_h2d: int = 0, warm_streamed: int = 0) -> dict:
    """Stream and warm medians of query() (which returns a QueryResult).

    Stream: the resident tier off and the feed cache off and emptied, so
    every feed is uploaded (the route measured before the tier).  Warm: both
    on, after two settling queries (the reference's range logic re-uploads a
    feed that lost the pinned slot once, into the cache).  A warm query that
    moves other than `warm_h2d` host-to-device bytes (0 unless the plan
    reads a hot remainder or a host batch, which stream by design), or
    serves other than all but `warm_streamed` feeds from the tier and the
    cache, fails the phase."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.engine.executor import clear_device_cache

    def timed(n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            r = query()
            out.append((time.perf_counter() - t0, r.exec_stats))
        return out

    saved = {f: flags.get(f) for f in ("PL_HBM_RESIDENT", "PIXIE_TPU_DEVICE_CACHE_MB")}
    flags.set_for_testing("PL_HBM_RESIDENT", False)
    flags.set_for_testing("PIXIE_TPU_DEVICE_CACHE_MB", 0)
    clear_device_cache()
    try:
        stream = timed(2 + reps)[2:]
        prof_stream = profile_query(query) if with_profile else None
    finally:
        for f, v in saved.items():
            flags.set_for_testing(f, v)
    for _t, st in stream:
        if st.get("resident_feeds", 0) or st.get("feed_cache_hits", 0) or not st["h2d_bytes"]:
            raise AssertionError(f"{label}: the stream route did not upload every feed: {st}")
    settle = timed(2)
    warm = timed(reps)
    for _t, st in warm:
        served = st.get("resident_feeds", 0) + st.get("feed_cache_hits", 0)
        if st["h2d_bytes"] != warm_h2d or served != st["feeds"] - warm_streamed:
            raise AssertionError(
                f"{label}: warm query moved {st['h2d_bytes']} H2D bytes, {served} of "
                f"{st['feeds']} feeds from the tier and the cache")

    def median(xs):
        ts = sorted(t for t, _ in xs)
        return ts[len(ts) // 2]

    last = warm[-1][1]
    out = {"stream_median_s": median(stream), "stream_s": sorted(t for t, _ in stream),
           "stream_h2d_bytes": stream[-1][1]["h2d_bytes"],
           "settle_h2d_bytes": [st["h2d_bytes"] for _t, st in settle],
           "warm_median_s": median(warm), "warm_s": sorted(t for t, _ in warm),
           "h2d_bytes": last["h2d_bytes"], "feeds": last["feeds"],
           "resident_feeds": last.get("resident_feeds", 0),
           "feed_cache_hits": last.get("feed_cache_hits", 0)}
    if with_profile:
        out["profile_stream"] = prof_stream
        out["profile_warm"] = profile_query(query)
    return out


def device_memory() -> dict:
    """Device bytes pinned by the resident tier and the feed cache."""
    from pixie_tpu_torch.engine import resident
    from pixie_tpu_torch.engine.executor import device_cache_stats

    tier = resident.tier_stats()
    return {"resident_entries": tier["entries"], "resident_bytes": tier["bytes"],
            "cache": device_cache_stats()}


def run_slice(dev, with_profile: bool) -> dict:
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore

    t0 = time.perf_counter()
    ts = TableStore()
    table, _gen = build_http_table(ts, ROWS)
    log(json.dumps({"phase": "slice.data", "rows": ROWS,
                    "seconds": time.perf_counter() - t0}))
    plan = http_plan()

    def query(**kw):
        r = execute_plan(plan, ts, device=dev, **kw)["output"]
        torch.cuda.synchronize(dev)
        return r

    _build.reset_launches()
    t0 = time.perf_counter()
    res = query()
    first_s = time.perf_counter() - t0
    launches = read_launches("config #1", CONFIG1_KERNELS)
    log(json.dumps({"phase": "slice.launches", "per_query": launches}))
    if launches["loghist_quantile"] or launches["finalize"].get(F2[1]) != 1:
        raise AssertionError(f"config #1: want F2 once and no K3: {launches}")
    check_leaves("config1", res.exec_stats)
    check = oracle_check(table, res)
    log(json.dumps({"phase": "slice.oracle", "ok": True, **check}))
    # always profiled: the warm idle share is a headline of the chain kernel
    routes = stream_and_warm(query, "config #1", with_profile=True)
    analyzed = execute_plan(plan, ts, device=dev, analyze=True)["output"].exec_stats
    return {"launches": launches, "first_query_s": first_s,
            "first_query_h2d_bytes": res.exec_stats["h2d_bytes"], **routes,
            "median_query_s": routes["warm_median_s"],
            "rows_per_s": ROWS / routes["warm_median_s"],
            "stream_rows_per_s": ROWS / routes["stream_median_s"],
            "analyze_feed_ms": [x / 1e6 for x in analyzed.get("feed_ns", [])],
            "device_memory": device_memory()}, ts, table


def _table_columns(table, names) -> dict:
    parts = {k: [] for k in names}
    for rb, _rid, _gen in table.cursor():
        for k in names:
            parts[k].append(rb.columns[k][: rb.num_valid])
    return {k: np.concatenate(v) for k, v in parts.items()}


def select_plan(head: int | None):
    """filter status == 500 → [head(n)] → select time_, service, latency,
    status."""
    from pixie_tpu_torch.plan import (Call, Column, FilterOp, LimitOp, MemorySinkOp,
                                      MemorySourceOp, Plan, lit)

    p = Plan()
    node = p.add(FilterOp(expr=Call("equal", (Column("status"), lit(500)))),
                 parents=[p.add(MemorySourceOp(table="http_events"))])
    if head is not None:
        node = p.add(LimitOp(n=head), parents=[node])
    p.add(MemorySinkOp(name="output", columns=["time_", "service", "latency", "status"]),
          parents=[node])
    return p


def run_select(dev, ts, table, with_profile: bool) -> dict:
    """Select phase over config #1's table: all status-500 rows, then the
    first 100000 of them; rows and order against a numpy oracle."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build

    names = ["time_", "service", "latency", "status"]
    cols = _table_columns(table, names)
    sel = np.nonzero(cols["status"] == 500)[0]
    out = {}
    for label, head in (("select", None), ("select_head", 100_000)):
        plan = select_plan(head)
        want_rows = sel if head is None else sel[:head]

        def query(plan=plan):
            r = execute_plan(plan, ts, device=dev)["output"]
            torch.cuda.synchronize(dev)
            return r

        _build.reset_launches()
        res = query()
        # the first select admits its feeds (R1); head(n) reads them warm
        launches = read_launches(label, SELECT_KERNELS if head is None else
                                 [k for k in SELECT_KERNELS if k[0] != "resident"])
        check_leaves(label, res.exec_stats)
        if res.num_rows != len(want_rows):
            raise AssertionError(f"{label}: {res.num_rows} rows, oracle {len(want_rows)}")
        for k in names:
            if not np.array_equal(np.asarray(res.columns[k]), cols[k][want_rows]):
                raise AssertionError(f"{label}: column {k} differs from the oracle")
        routes = stream_and_warm(query, label, with_profile and head is None)
        out[label] = {"rows": res.num_rows, "launches": launches,
                      "first_query_h2d_bytes": res.exec_stats["h2d_bytes"], **routes,
                      "median_query_s": routes["warm_median_s"],
                      "pipelined_waves": res.exec_stats.get("pipelined_waves", 0),
                      "device_memory": device_memory()}
        log(json.dumps({"phase": f"slice.{label}", "ok": True,
                        **{k: v for k, v in out[label].items() if k != "launches"}}))
    return out


def run_config3(dev) -> dict:
    """bench_config3 through the port: 24 services with exact int64 sums."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.plan import (AggExpr, AggOp, JoinOp, MemorySinkOp,
                                      MemorySourceOp, Plan)
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    n_pods, rows = 256, CONFIG3_ROWS
    ts = TableStore()
    t = ts.create("network_stats", Relation.of(
        ("time_", DT.TIME64NS), ("pod_id", DT.STRING), ("rx_bytes", DT.INT64),
        ("tx_bytes", DT.INT64)), batch_rows=1 << 16, max_bytes=1 << 36)
    pods = np.array([f"pod-{i}" for i in range(n_pods)])
    pod_idx, rx, tx = [], [], []
    written, chunk = 0, 1 << 21
    while written < rows:
        n = min(chunk, rows - written)
        pi = rng.integers(0, n_pods, n)
        r_, x_ = rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 20, n)
        t.write({"time_": np.arange(written, written + n, dtype=np.int64),
                 "pod_id": pods[pi], "rx_bytes": r_, "tx_bytes": x_})
        pod_idx.append(pi)
        rx.append(r_)
        tx.append(x_)
        written += n
    services = np.array([f"svc-{i % 24}" for i in range(n_pods)])
    ts.create("pods", Relation.of(("pod_id", DT.STRING), ("service", DT.STRING))).write(
        {"pod_id": pods, "service": services})
    log(json.dumps({"phase": "config3.data", "rows": rows,
                    "seconds": time.perf_counter() - t0}))

    p = Plan()
    agg = p.add(AggOp(groups=["pod_id"], values=[
        AggExpr("rx", "sum", "rx_bytes"), AggExpr("tx", "sum", "tx_bytes")]),
        parents=[p.add(MemorySourceOp(table="network_stats"))])
    join = p.add(JoinOp(how="inner", left_on=["pod_id"], right_on=["pod_id"],
                        output=[("left", "pod_id", "pod_id"), ("left", "rx", "rx"),
                                ("left", "tx", "tx"), ("right", "service", "service")]),
                 parents=[agg, p.add(MemorySourceOp(table="pods"))])
    agg2 = p.add(AggOp(groups=["service"], values=[
        AggExpr("rx", "sum", "rx"), AggExpr("tx", "sum", "tx")]), parents=[join])
    p.add(MemorySinkOp(name="output"), parents=[agg2])

    def query():
        r = execute_plan(p, ts, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    _build.reset_launches()
    res = query()
    launches = read_launches("config #3", CONFIG3_KERNELS)
    check_leaves("config3", res.exec_stats)
    # oracle: int64 sums per pod, then per service (svc index = pod % 24)
    pod_idx, rx, tx = (np.concatenate(v) for v in (pod_idx, rx, tx))
    svc_of_pod = np.arange(n_pods) % 24
    # (float64 bincounts are exact here: every sum is an integer below 2^53)
    want = {}
    for name, v in (("rx", rx), ("tx", tx)):
        per_pod = np.bincount(pod_idx, weights=v, minlength=n_pods)
        per_svc = np.bincount(svc_of_pod, weights=per_pod, minlength=24)
        if per_svc.max() >= 2.0 ** 53:
            raise AssertionError("config #3 oracle: sums beyond float64's exact integers")
        want[name] = per_svc.astype(np.int64)
    got_svc = [int(s.split("-")[1]) for s in res.decoded("service")]
    if res.num_rows != 24 or sorted(got_svc) != list(range(24)):
        raise AssertionError(f"config #3: {res.num_rows} rows, want the 24 services")
    for name in ("rx", "tx"):
        if not np.array_equal(np.asarray(res.columns[name]), want[name][got_svc]):
            raise AssertionError(f"config #3: {name} sums differ from the oracle")
    st = res.exec_stats
    if st.get("device_joins", 0) != 0:
        raise AssertionError("config #3's 256-row join left the host match")
    # The 256-row pods table is an unsealed hot remainder (bench writes it
    # into 64K-row batches) and the join's 256 rows reach the second agg as
    # a host batch: both stream every query, by design, as in the reference.
    # Everything else (the 16M network_stats rows) must move 0 bytes warm.
    routes = stream_and_warm(query, "config #3", warm_streamed=2,
                             warm_h2d=n_pods * (4 + 4) + n_pods * (4 + 8 + 8))
    out = {"rows": res.num_rows, "launches": launches,
           "first_query_h2d_bytes": res.exec_stats["h2d_bytes"], **routes,
           "median_query_s": routes["warm_median_s"],
           "rows_per_s": rows / routes["warm_median_s"],
           "stream_rows_per_s": rows / routes["stream_median_s"],
           "join_route": "host match (_match_pairs): the join has 256 rows a side, "
                         "below the 2^16-row device gate",
           "device_memory": device_memory()}
    log(json.dumps({"phase": "slice.config3", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


def run_device_join(dev, with_profile: bool) -> dict:
    """An executor-level inner join of two 2^22-row tables on the card."""
    import torch

    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.plan import JoinOp, MemorySinkOp, MemorySourceOp, Plan
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    n = EXEC_JOIN_ROWS
    rng = np.random.default_rng(9)
    lk, rk = rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 20, n)
    ts = TableStore()
    ts.create("left", Relation.of(("k", DT.INT64), ("a", DT.INT64)), batch_rows=1 << 16,
              max_bytes=1 << 34).write({"k": lk, "a": np.arange(n, dtype=np.int64)})
    ts.create("right", Relation.of(("k", DT.INT64), ("b", DT.INT64)), batch_rows=1 << 16,
              max_bytes=1 << 34).write({"k": rk, "b": np.arange(n, dtype=np.int64)})
    p = Plan()
    j = p.add(JoinOp(how="inner", left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "a", "a"), ("right", "b", "b")]),
              parents=[p.add(MemorySourceOp(table="left")),
                       p.add(MemorySourceOp(table="right"))])
    p.add(MemorySinkOp(name="out"), parents=[j])

    def run(analyze=False):
        ex = PlanExecutor(p, ts, device=dev, analyze=analyze)
        r = ex.run()["out"]
        torch.cuda.synchronize(dev)
        return r, ex.stats

    _build.reset_launches()
    res, st = run()
    launches = read_launches("device join", JOIN_KERNELS)
    gate = st.get("device", {}).get("join_gate", {})
    if st.get("device_joins", 0) != 1 or gate.get("reason") != "h2d_direct_attached":
        raise AssertionError(f"device join: device_joins={st.get('device_joins')}, "
                             f"gate={gate}")
    # oracle: every (left row, right row) with equal k; rows (k, a, b) sorted
    # by (a, b), which are unique row ids
    order = np.argsort(rk, kind="stable")
    lo = np.searchsorted(rk[order], lk, "left")
    hi = np.searchsorted(rk[order], lk, "right")
    cnt = hi - lo
    a_w = np.repeat(np.arange(n, dtype=np.int64), cnt)
    b_w = order[np.repeat(lo, cnt) + (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt))]
    want = np.sort(a_w * n + b_w)
    a_g, b_g, k_g = (np.asarray(res.columns[c]) for c in ("a", "b", "k"))
    got_key = a_g * n + b_g
    if len(got_key) != len(want) or not np.array_equal(np.sort(got_key), want) \
            or not np.array_equal(k_g, lk[a_g]) or not np.array_equal(k_g, rk[b_g]):
        raise AssertionError("device join: rows differ from the numpy oracle")
    times = warm_times(lambda: run(), warmup=1, reps=3)
    _res, st_an = run(analyze=True)
    out = {"pairs": int(len(got_key)), "launches": launches, "gate": gate,
           "query_s": times, "median_query_s": times[len(times) // 2],
           "split_s": st_an["join_split_s"]}
    log(json.dumps({"phase": "slice.device_join", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    if with_profile:
        log(json.dumps({"phase": "slice.device_join.profile",
                        **profile_query(lambda: run())}))
    return out


def same_agg(a, b, label: str) -> None:
    """Two config #1 results over the same rows: groups, counts and p50
    exactly, means to rtol 1e-12 (atomic float sums add in any order)."""
    def rows(r):
        key = r.columns["service"].astype(np.int64) * 1000 + r.columns["status"]
        o = np.argsort(key)
        return key[o], {c: np.asarray(r.columns[c])[o] for c in ("cnt", "avg_lat", "p50")}

    ka, ca = rows(a)
    kb, cb = rows(b)
    if not (np.array_equal(ka, kb) and np.array_equal(ca["cnt"], cb["cnt"])
            and np.array_equal(ca["p50"], cb["p50"])
            and np.allclose(ca["avg_lat"], cb["avg_lat"], rtol=1e-12, atol=0)):
        raise AssertionError(f"{label}: the resident route and the stream route disagree")


def run_resident(dev) -> dict:
    """Config #1 over 8M-row tables: admission, a warm hit, a fold with a
    grow, and a retention rebase with a grow and a fold; each result held
    against the stream route and the numpy oracle."""
    import torch

    from pixie_tpu_torch import flags
    from pixie_tpu_torch.engine import resident
    from pixie_tpu_torch.engine.executor import PlanExecutor, clear_device_cache
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore

    plan = http_plan()
    out = {}

    def query(ts):
        t0 = time.perf_counter()
        ex = PlanExecutor(plan, ts, device=dev)
        r = ex.run()["output"]
        torch.cuda.synchronize(dev)
        return r, {"s": time.perf_counter() - t0, "h2d_bytes": ex.stats["h2d_bytes"],
                   "resident_feeds": ex.stats.get("resident_feeds", 0),
                   "feeds": ex.stats["feeds"]}

    def stream(ts):
        saved = {f: flags.get(f) for f in ("PL_HBM_RESIDENT", "PIXIE_TPU_DEVICE_CACHE_MB")}
        flags.set_for_testing("PL_HBM_RESIDENT", False)
        flags.set_for_testing("PIXIE_TPU_DEVICE_CACHE_MB", 0)
        clear_device_cache()
        try:
            return query(ts)[0]
        finally:
            for f, v in saved.items():
                flags.set_for_testing(f, v)

    def expect(label, st, tier0, h2d, **deltas):
        tier = resident.tier_stats()
        moved = {k: tier[k] - tier0[k] for k in deltas}
        if st["h2d_bytes"] != h2d or moved != deltas or st["resident_feeds"] != st["feeds"]:
            raise AssertionError(f"resident {label}: h2d {st['h2d_bytes']} (want {h2d}), "
                                 f"tier {moved} (want {deltas}), {st}")

    delta_bytes = RESIDENT_APPEND * CONFIG1_ROW_BYTES
    _build.reset_launches()
    for label, cap_rows, append in (("fold", None, RESIDENT_APPEND),
                                    ("rebase", RESIDENT_ROWS + RESIDENT_APPEND,
                                     2 * RESIDENT_APPEND)):
        t0 = time.perf_counter()
        ts = TableStore()
        max_bytes = (1 << 36) if cap_rows is None else cap_rows * 28  # 28 B/row stored
        table, gen = build_http_table(ts, RESIDENT_ROWS, max_bytes=max_bytes)
        data_s = time.perf_counter() - t0
        tier0 = resident.tier_stats()
        _r, cold = query(ts)
        expect(f"{label} cold", cold, tier0, RESIDENT_ROWS * CONFIG1_ROW_BYTES, admissions=1)
        tier0 = resident.tier_stats()
        _r, warm = query(ts)
        expect(f"{label} warm", warm, tier0, 0, hits=1)
        lo = table.first_row_id()
        gen.write(append)  # sealed batches of 2^16 rows
        trimmed = table.first_row_id() - lo
        tier0 = resident.tier_stats()
        res, st = query(ts)
        if label == "fold":
            expect("fold", st, tier0, delta_bytes, folds=1, rebases=0)
        else:
            if trimmed != RESIDENT_APPEND:
                raise AssertionError(f"resident rebase: {trimmed} rows trimmed, "
                                     f"want {RESIDENT_APPEND}")
            expect("rebase", st, tier0, append * CONFIG1_ROW_BYTES, folds=1, rebases=1)
        tier = resident.tier_stats()
        check = oracle_check(table, res)
        same_agg(res, stream(ts), f"resident {label}")
        _r, warm2 = query(ts)
        out[label] = {"table_rows": RESIDENT_ROWS, "appended": append, "trimmed": trimmed,
                      "data_s": data_s, "cold": cold, "warm": warm, "after_append": st,
                      "warm_after": warm2, "tier_bytes": tier["bytes"], "oracle": check}
        log(json.dumps({"phase": f"resident.{label}", "ok": True, **out[label]}))
        del ts, table, gen
    out["launches"] = read_launches("resident", RESIDENT_KERNELS)
    routed = [f"{lib}.{e}" for lib, e in CONFIG1_KERNELS[:4] + [K3]
              if out["launches"][lib].get(e, 0)]
    if routed:
        raise AssertionError(f"resident: one-feed queries launched {routed} beside F1")
    out["device_memory"] = device_memory()
    return out


#: bytes a row that each K1 / K2 entry point reads (group id, mask, value)
ROW_READ_BYTES = {"px_segment_count": 4 + 1, "px_segment_sum_i64": 4 + 1 + 8,
                  "px_segment_sum_f64": 4 + 1 + 8, "px_segment_min_f64": 4 + 1 + 8,
                  "px_segment_max_f64": 4 + 1 + 8, "px_loghist_update": 4 + 1 + 8}


class plain_routes:
    """K1-K3's and KM1-KM3's wrappers run their plain versions on the same
    CUDA tensors (no launch, none counted), for the plain time of a row
    that is host code over those kernels (rows 9 and 17d)."""

    def __enter__(self):
        from pixie_tpu_torch.ops import groupby as gb
        from pixie_tpu_torch.ops import kmeans as kops
        from pixie_tpu_torch.ops.sketch import LogHistogram

        def k1(kind, gid, mask, values, out, num_groups):
            if kind == "count":
                gb.segment_count_plain(gid, num_groups, mask, out)
            elif kind == "sum":
                gb.segment_sum_plain(values, gid, num_groups, mask, out)
            else:
                gb.segment_pick_plain(values, gid, num_groups, mask, out, kind)

        swaps = [(gb, "_launch_k1", k1),
                 (LogHistogram, "_launch_update", LogHistogram.update_plain),
                 (LogHistogram, "_launch_quantile", LogHistogram.quantile_plain),
                 (kops, "assign", kops.assign_plain),
                 (kops, "lloyd_step", kops.lloyd_step_plain),
                 (kops, "seed_step", kops.seed_step_plain)]
        self.saved = [(owner, name, getattr(owner, name)) for owner, name, _f in swaps]
        for owner, name, f in swaps:
            setattr(owner, name, f)

    def __exit__(self, *exc):
        for owner, name, f in self.saved:
            setattr(owner, name, f)


def sorted_bound(launches: dict, n: int, g: int) -> tuple[float, str]:
    """Row 9's bound: the sum of its kernels' bounds over one sorted query of
    n rows into g groups, from the query's launches — each K1 / K2 launch
    reads its chunk's ids, mask and values once, each leaf's state of g
    groups is read and written once a query, and K3 reads the sketches and
    writes g quantiles."""
    chunks = -(-n // (1 << 20))
    nbytes = 0.0
    for lib in ("segment_reduce", "loghist_update"):
        for e, c in launches.get(lib, {}).items():
            state = g * (WIDTH * 4 if lib == "loghist_update" else 8)
            nbytes += (c / chunks) * (n * ROW_READ_BYTES[e] + 2 * state)
    nbytes += launches.get("loghist_quantile", {}).get("px_loghist_quantile", 0) * (
        g * WIDTH * 4 + g * 8)
    return bound(nbytes)


def coreset_bound(n: int, d: int, k: int) -> tuple[float, str]:
    """Row 17d's bound: one kmeans_coreset of n points — k - 1 KM3 steps, 5
    KM2 steps, one KM1 assignment and K1's f64 sum of the masses — as the
    sum of those kernels' bounds (rows 17a-c, 1) at this shape."""
    ms = ((k - 1) * bound(n * d * 4 + n * 16 + d * 4, 4.0 * n * d)[0]
          + 5 * bound(n * d * 4 + n * 4 + 2 * k * d * 4 + k * 4,
                      2.0 * n * k * d + 2.0 * n * (d + 1))[0]
          + bound(n * d * 4 + k * d * 4 + n * 12, 2.0 * n * k * d)[0]
          + bound(n * (4 + 1 + 8) + 2 * k * 8, n)[0])
    return ms, "sum of kernels"


def run_sorted(dev) -> dict:
    """S1 and S2 through the sorted fallback, each against numpy."""
    import torch

    from pixie_tpu_torch.engine.executor import MAX_GROUPS, PlanExecutor
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.plan import (AggExpr, AggOp, Call, Column, MapOp, MemorySinkOp,
                                      MemorySourceOp, Plan, lit)
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    n = SORTED_ROWS
    conn = rng.integers(0, CONN_IDS, n)
    nbytes = rng.integers(0, BYTES_RANGE, n)
    lat = rng.exponential(50.0, n)
    ts = TableStore()
    ts.create("conns", Relation.of(("time_", DT.TIME64NS), ("conn_id", DT.INT64),
                                   ("bytes", DT.INT64), ("latency", DT.FLOAT64)),
              batch_rows=1 << 16, max_bytes=1 << 36).write(
        {"time_": np.arange(n, dtype=np.int64), "conn_id": conn, "bytes": nbytes,
         "latency": lat})
    log(json.dumps({"phase": "sorted.data", "rows": n, "seconds": time.perf_counter() - t0}))

    def plan(groups, values, maps=None):
        p = Plan()
        node = p.add(MemorySourceOp(table="conns"))
        if maps:
            node = p.add(MapOp(exprs=maps), parents=[node])
        agg = p.add(AggOp(groups=groups, values=values), parents=[node])
        p.add(MemorySinkOp(name="out"), parents=[agg])
        return p

    s1 = plan(["conn_id"], [AggExpr("cnt", "count", None), AggExpr("sb", "sum", "bytes"),
                            AggExpr("avg", "mean", "latency"), AggExpr("mn", "min", "latency"),
                            AggExpr("mx", "max", "latency")])
    s2 = plan(["b"], [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
                      AggExpr("p50", "p50", "latency")],
              maps=[("b", Call("bin", (Column("bytes"), lit(4096)))),
                    ("latency", Column("latency"))])

    def run(p):
        t0 = time.perf_counter()
        ex = PlanExecutor(p, ts, device=dev)
        r = ex.run()["out"]
        torch.cuda.synchronize(dev)
        st = ex.stats
        if st.get("sorted_agg_fallbacks", 0) != 1:
            raise AssertionError(f"sorted: {st.get('sorted_agg_fallbacks')} fallbacks, want 1")
        frames = {f["label"]: f["wall_ns"] / 1e9 for f in st["operators"]}
        return r, {"s": time.perf_counter() - t0, "h2d_bytes": st["h2d_bytes"],
                   "operators_s": frames}

    def by_entry():
        return {n_: dict(k.by_entry) for n_, k in _build.KERNELS.items()}

    _build.reset_launches()
    r1, st1 = run(s1)
    after1 = by_entry()
    r2, st2 = run(s2)
    launches = read_launches("sorted", SORTED_KERNELS)
    # row 9's plain time: the same queries with K1-K3's plain versions
    with plain_routes():
        r1p, st1p = run(s1)
        r2p, st2p = run(s2)
    for label, key, got, want in (("S1", "conn_id", r1p, r1), ("S2", "b", r2p, r2)):
        og, ow = np.argsort(got.columns[key]), np.argsort(want.columns[key])
        for c in want.columns:
            g, w = np.asarray(got.columns[c])[og], np.asarray(want.columns[c])[ow]
            ok = (np.allclose(g, w, rtol=1e-12, atol=0) if c == "avg"
                  else np.array_equal(g, w))
            if not ok:
                raise AssertionError(f"sorted {label}: {c} differs on the plain routes")
    st1["plain_operators_s"], st2["plain_operators_s"] = (st1p["operators_s"],
                                                          st2p["operators_s"])
    per_query = {"S1": after1, "S2": {lib: {e: c - after1[lib].get(e, 0) for e, c in es.items()}
                                      for lib, es in launches.items()}}

    # ---- S1 oracle: groups, exact counts and int64 sums, means, min, max
    u, inv, cnt = np.unique(conn, return_inverse=True, return_counts=True)
    G = len(u)
    order = np.argsort(inv, kind="stable")
    starts = np.cumsum(cnt) - cnt
    sb = np.bincount(inv, weights=nbytes, minlength=G)
    if sb.max() >= 2.0 ** 53:
        raise AssertionError("sorted oracle: sums beyond float64's exact integers")
    want1 = {"conn_id": u, "cnt": cnt, "sb": sb.astype(np.int64),
             "avg": np.bincount(inv, weights=lat, minlength=G) / cnt,
             "mn": np.minimum.reduceat(lat[order], starts),
             "mx": np.maximum.reduceat(lat[order], starts)}
    o = np.argsort(r1.columns["conn_id"])
    got1 = {k: np.asarray(r1.columns[k])[o] for k in want1}
    if r1.num_rows != G or G <= MAX_GROUPS:
        raise AssertionError(f"S1: {r1.num_rows} groups, oracle {G} (must exceed {MAX_GROUPS})")
    for k in ("conn_id", "cnt", "sb", "mn", "mx"):
        if not np.array_equal(got1[k], want1[k]):
            raise AssertionError(f"S1: {k} differs from the oracle")
    if not np.allclose(got1["avg"], want1["avg"], rtol=1e-12, atol=0):
        raise AssertionError("S1: means differ from the oracle beyond rtol 1e-12")
    gb = 1 << max(0, G - 1).bit_length()
    st1.update({"groups": G, "state_groups": gb,
                "bound_ms": sorted_bound(per_query["S1"], n, G)[0],
                # K1 keeps G int64 accumulators a block in shared memory only
                # up to the 227 KB a block may opt in to
                "k1_global_atomics": gb * 8 > 232448})

    # ---- S2 oracle: bin(bytes, 4096) groups, counts, means, p50
    key = nbytes // 4096
    ng = int(key.max()) + 1
    cnt2, mean2, p50_bin, median2 = sketch_oracle(key, lat, ng)
    present = np.nonzero(cnt2)[0]
    o = np.argsort(r2.columns["b"])
    b = np.asarray(r2.columns["b"])[o]
    if not np.array_equal(b, present * 4096):
        raise AssertionError("S2: bins differ from the oracle")
    if not np.array_equal(np.asarray(r2.columns["cnt"])[o], cnt2[present]):
        raise AssertionError("S2: counts differ from the oracle")
    if not np.allclose(np.asarray(r2.columns["avg"])[o], mean2[present], rtol=1e-9, atol=0):
        raise AssertionError("S2: means differ from the oracle beyond rtol 1e-9")
    exact, rel = check_p50(np.asarray(r2.columns["p50"])[o], p50_bin[present], median2[present])
    st2.update({"groups": len(present), "p50_exact_bin": exact, "p50_max_rel_err_vs_median": rel,
                "bound_ms": sorted_bound(per_query["S2"], n, len(present))[0]})
    out = {"S1": st1, "S2": st2, "launches": launches, "s1_launches": per_query["S1"],
           "device_memory": device_memory()}
    log(json.dumps({"phase": "sorted", "ok": True,
                    **{k: v for k, v in out.items() if k not in ("launches", "s1_launches")}}))
    return out


# ------------------------------------------------------------- config #4


def check_merge_kernel(dev) -> list[dict]:
    """M1 held against its plain version on config #4's state (8 agents x
    64 groups: count, mean, p50 sketch, seen) and at a bandwidth shape
    (8 states x 2^16 groups: count, mean, min, max, p50, seen; ~138 MB a
    state).  Exact (every leaf folds in agent order in both); returns its
    kernel row, with the bandwidth shape's times in the shape detail."""
    import torch

    from pixie_tpu_torch.ops import merge as m1
    from pixie_tpu_torch.udf.udf import tree_map

    rng = np.random.default_rng(15)

    def states(g, with_minmax):
        rt = {"cnt": "add", "avg_lat": {"sum": "add", "count": "add"}, "p50": "add",
              "__seen": "add"}
        if with_minmax:
            rt.update({"lo": "min", "hi": "max"})
        out = []
        for _ in range(CONFIG4_AGENTS):
            st = {"cnt": rng.integers(0, 1 << 20, g),
                  "avg_lat": {"sum": rng.exponential(50.0, g) * 1e4,
                              "count": rng.integers(0, 1 << 20, g)},
                  "p50": rng.integers(0, 1 << 12, (g, WIDTH)).astype(np.float32),
                  "__seen": rng.integers(0, 1 << 20, g)}
            if with_minmax:
                lo = rng.exponential(50.0, g)
                lo[rng.integers(0, g, 4)] = np.nan
                st.update({"lo": lo, "hi": lo * 3})
            out.append(tree_map(lambda a: torch.from_numpy(a).to(dev), st))
        return rt, out

    def leaves(t):
        return [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    def hold(label, rt, sts):
        got = state_tree(m1.merge_states(rt, sts))
        want = m1.merge_states_plain(rt, sts)
        torch.cuda.synchronize()
        for a, b in zip(leaves(got), leaves(want)):
            if not same_bits(a, b):
                raise AssertionError(f"M1 {label}: kernel and plain version disagree")
        log(json.dumps({"check": f"M1 {label}", "ok": True, "max_abs_err": 0.0}))
        nbytes = sum(x.numel() * x.element_size() for x in leaves(sts[0]))
        b_ms, by = bound((len(sts) + 1) * nbytes)

        def library():
            for path_leaves, op in zip(zip(*[leaves(x) for x in sts]), leaves_ops(rt)):
                st_ = torch.stack(path_leaves)
                st_.sum(0) if op == "add" else (st_.amin(0) if op == "min" else st_.amax(0))

        return {"ms": cuda_ms(lambda: m1.merge_states(rt, sts), 20),
                "device_ms": kernel_device_ms(lambda: m1.merge_states(rt, sts), 20),
                "host_us": host_us(lambda: m1.merge_states(rt, sts)),
                "plain_ms": cuda_ms(lambda: m1.merge_states_plain(rt, sts), 10),
                "library_ms": cuda_ms(library, 10),
                "library_host_us": host_us(library), "bound_ms": b_ms, "bound_by": by,
                "state_bytes": nbytes, "states": len(sts)}

    def leaves_ops(t):
        return [x for v in t.values()
                for x in (leaves_ops(v) if isinstance(v, dict) else [v])]

    rt, sts = states(64, False)
    small = hold("config #4 state (8 x 64 groups)", rt, sts)
    rt, sts = states(1 << 16, True)
    wide = hold("bandwidth shape (8 x 2^16 groups)", rt, sts)
    del sts
    torch.cuda.empty_cache()
    past = m1_past_capacity(dev, m1.merge_states, "past one launch's capacity")
    log(json.dumps({"kernel_detail": "merge_states", "config4_state": small,
                    "bandwidth_shape": wide, "past_capacity": past}))
    return [{
        "name": "merge_states", "route": "cuda", "source": "pixie_tpu_torch/csrc/merge.cu",
        "replaces": "pixie_tpu/engine/executor.py:656 ChainKernel.merge_states_fn "
                    "(:1030 gang_merge_states)",
        "entry": ("merge", "px_merge_states"), "path": "config4", "max_abs_err": 0.0,
        "ms": small["ms"], "plain_ms": small["plain_ms"], "bound_ms": small["bound_ms"],
        "bound_by": small["bound_by"], "library_ms": small["library_ms"],
        "shape": {"config4_state": {"groups": 64, "states": CONFIG4_AGENTS,
                                    "state_bytes": small["state_bytes"]},
                  "bandwidth_shape": {"groups": 1 << 16, **wide},
                  "past_capacity": past, "host_us": small["host_us"],
                  "device_ms": small["device_ms"]},
    }]


def h2d_copies(fn, reps: int = 3) -> dict:
    """Host-to-device copies per call of fn() in its CUDA-only profile (fn
    called once first), beside the device events the profile holds: a
    count of 0 means something only when the profile saw the call's
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    h2d = [e for e in ev if "HtoD" in e.key]
    return {"h2d_per_call": sum(e.count for e in h2d) / reps,
            "h2d_events": sorted({e.key[:60] for e in h2d}),
            "device_events_per_call": sum(e.count for e in ev) / reps}


def kernel_device_ms(fn, reps: int) -> float:
    """Device time per call of fn(), which launches its kernel without a
    host synchronize: CUDA events around `reps` calls that the host
    enqueues while the device sleeps, so the wrapper's host time, which
    CUDA events around a host-bound call also measure, is hidden (the gaps
    between the calls' launches on the device count).  The sleep must
    outlast the enqueue: if the start event has run when the last call is
    enqueued, it is taken again with a sleep four times longer, twice at
    most, and then fails the run.  (torch.profiler dropped 4 of 10 G1
    launches from every profile in one whole run, so it is no source of a
    kernel's device time here.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    sleep_s = max(0.005, 2.0 * (time.perf_counter() - t0))
    for _attempt in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles at up to ~2 GHz
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        sleep_s *= 4
    raise AssertionError("kernel_device_ms: the device reached the first call before the "
                         "host had enqueued the last, three times")


def device_busy_ms(fn, reps: int) -> float:
    """Device time per call of every event (kernels and copies) of fn(), a
    whole query, from torch.profiler's CUDA activity over `reps` calls;
    the profile may hold none of them (§7 of PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in ev) / 1e3 / reps


def cluster_oracle(tables, res) -> dict:
    """numpy oracle of config #4 over every agent table's rows (service
    decoded to its index, so each table's private dictionary is read as
    values); raises on mismatch, as oracle_check."""
    svc, lat, st = [], [], []
    for t in tables:
        cols = _table_columns(t, ("service", "latency", "status"))
        names = t.dictionaries["service"].decode(np.arange(t.dictionaries["service"].size))
        idx = np.array([int(v.split("-")[1]) for v in names], dtype=np.int64)
        svc.append(idx[cols["service"]])
        lat.append(cols["latency"])
        st.append(cols["status"])
    svc, lat, st = np.concatenate(svc), np.concatenate(lat), np.concatenate(st)
    sel = st != 404
    svc, lat, st = svc[sel], lat[sel], st[sel]
    statuses = np.unique(st)
    key = svc * len(statuses) + np.searchsorted(statuses, st)
    ng = N_SERVICES * len(statuses)
    cnt, mean, sketch_p50, median = sketch_oracle(key, lat, ng)
    got_svc = np.array([int(v.split("-")[1]) for v in res.decoded("service")], dtype=np.int64)
    got_key = got_svc * len(statuses) + np.searchsorted(statuses, res.columns["status"])
    if res.num_rows != int((cnt > 0).sum()):
        raise AssertionError(f"groups: got {res.num_rows}, want {(cnt > 0).sum()}")
    if not np.array_equal(np.asarray(res.columns["cnt"]), cnt[got_key]):
        raise AssertionError("counts differ from the oracle")
    if not np.allclose(res.columns["avg_lat"], mean[got_key], rtol=1e-9, atol=0):
        raise AssertionError("means differ from the oracle beyond rtol 1e-9")
    exact, rel = check_p50(np.asarray(res.columns["p50"]), sketch_p50[got_key],
                           median[got_key])
    if not all(np.isfinite(np.asarray(res.columns[c], dtype=np.float64)).all()
               for c in ("cnt", "avg_lat", "p50")):
        raise AssertionError("non-finite results")
    return {"groups": res.num_rows, "rows": int(len(sel)), "p50_exact_bin": exact,
            "p50_max_rel_err_vs_median": rel}


def cluster_query(cluster, dev, m1_launches: int, p1_launches: int | None = None):
    """→ query() for stream_and_warm: one cluster.query of config #4's
    script whose result carries the agents' summed feed counters and its
    device-to-host copies (`d2h_leaves`), failing unless M1 launched exactly
    `m1_launches` times in it (and P1 `p1_launches` times, when given)."""
    import torch

    from pixie_tpu_torch.engine import transfer
    from pixie_tpu_torch.ops import _build

    def query():
        before = _build.KERNELS["merge"].launches
        packs = _build.KERNELS["pack"].launches
        d2h = transfer.stats["leaves"]
        res = cluster.query(CONFIG4_SCRIPT)["output"]
        torch.cuda.synchronize(dev)
        got = _build.KERNELS["merge"].launches - before
        got_p1 = _build.KERNELS["pack"].launches - packs
        if got != m1_launches or p1_launches not in (None, got_p1):
            raise AssertionError(f"config #4: M1 launched {got} times and P1 {got_p1} in a "
                                 f"query, want {m1_launches} and {p1_launches}")
        res.exec_stats["d2h_leaves"] = transfer.stats["leaves"] - d2h
        agents = res.exec_stats["agents"].values()
        res.exec_stats.update({k: sum(a.get(k, 0) for a in agents) for k in
                               ("h2d_bytes", "feeds", "resident_feeds", "feed_cache_hits")})
        return res

    return query


def _agent_stores(rows_each: int, services_of=None, agents: int = CONFIG4_AGENTS):
    """`agents` stores built as bench_config4 builds them (build_http_table,
    seed 12, 65,536-row batches); services_of(a), when given, restricts
    agent a to that subset of the 16 services."""
    from pixie_tpu_torch.table import TableStore

    stores, tables = {}, []
    for a in range(agents):
        ts = TableStore()
        if services_of is None:
            t, _gen = build_http_table(ts, rows_each)
        else:
            t, gen = build_http_table(ts, 0)
            gen = HttpRows(t, rows_each)
            gen.services = np.array([f"svc-{i}" for i in services_of(a)])
            gen.write(rows_each)
        stores[f"pem{a}"] = ts
        tables.append(t)
    return stores, tables


def run_config4(dev) -> dict:
    """Bench config #4 from PxL text: 8 agent stores of 2M rows (identical,
    so the states merge on the device: M1 once per query), then the
    mixed-dictionary run (8 x 1M rows, a different service subset per
    agent: the host value-keyed merge, M1 never launched)."""
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster

    t0 = time.perf_counter()
    stores, tables = _agent_stores(CONFIG4_ROWS // CONFIG4_AGENTS)
    log(json.dumps({"phase": "config4.data", "agents": CONFIG4_AGENTS,
                    "rows": CONFIG4_ROWS, "seconds": time.perf_counter() - t0}))
    cluster = LocalCluster(stores, device=dev)
    query = cluster_query(cluster, dev, m1_launches=1, p1_launches=0)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = query()
    first_s = time.perf_counter() - t0
    launches = read_launches("config #4", CONFIG4_KERNELS)
    check_leaves("config4", {"chain_leaves": sum(
        a.get("chain_leaves", 0) for a in res.exec_stats["agents"].values())})
    check = cluster_oracle(tables, res)
    log(json.dumps({"phase": "config4.oracle", "ok": True, **check}))
    routes = stream_and_warm(query, "config #4", with_profile=True)
    out = {"launches": launches, "route": "gang merge (M1 once per query, no P1)",
           "first_query_s": first_s, "first_query_h2d_bytes": res.exec_stats["h2d_bytes"],
           "first_query_d2h_leaves": res.exec_stats["d2h_leaves"],
           **routes, "rows_per_s": CONFIG4_ROWS / routes["warm_median_s"],
           "stream_rows_per_s": CONFIG4_ROWS / routes["stream_median_s"],
           "plan_cache": {"hits": cluster.plan_cache.hits,
                          "misses": cluster.plan_cache.misses},
           "device_memory": device_memory()}
    if cluster.plan_cache.misses != 1:
        raise AssertionError(f"config #4: the plan cache missed {cluster.plan_cache.misses} "
                             "times, want 1")
    for k in ("profile_stream", "profile_warm"):
        out[k] = {kk: v for kk, v in out[k].items() if kk != "top"} | {
            "top": out[k]["top"][:8]}
    warm = query()
    out["warm_phases_ms"] = {k: v / 1e6 for k, v in warm.exec_stats["phases"].items()}
    out["warm_d2h_leaves"] = warm.exec_stats["d2h_leaves"]
    log(json.dumps({"phase": "slice.config4", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    del cluster, stores, tables

    # ---- mixed dictionaries: agent a holds services a .. a + 7 (mod 16)
    t0 = time.perf_counter()
    stores, tables = _agent_stores(MIXED_ROWS, lambda a: [(a + k) % N_SERVICES
                                                          for k in range(8)])
    cluster = LocalCluster(stores, device=dev)
    data_s = time.perf_counter() - t0
    query = cluster_query(cluster, dev, m1_launches=0, p1_launches=CONFIG4_AGENTS)
    _build.reset_launches()
    res = query()
    mixed_launches = read_launches("config #4 mixed", MIXED_KERNELS)
    check = cluster_oracle(tables, res)
    times = warm_times(query, warmup=1, reps=3)
    mixed = {"route": "host value-keyed merge (M1 not launched)", "agents": CONFIG4_AGENTS,
             "rows": CONFIG4_AGENTS * MIXED_ROWS, "data_s": data_s, **check,
             "warm_median_s": times[len(times) // 2], "warm_s": times,
             "h2d_bytes": res.exec_stats["h2d_bytes"], "d2h_leaves": res.exec_stats["d2h_leaves"],
             "p1_launches": mixed_launches["pack"].get(P1[1], 0)}
    log(json.dumps({"phase": "slice.config4_mixed", "ok": True, **mixed}))
    out["mixed"] = mixed
    return out


# ------------------------------------------------------------- the ML path

#: the k-means kernels' shape: 2^20 points at the width of _text_embedding
ML_N, ML_D, ML_K, ML_ITERS = 1 << 20, 64, 64, 10
#: blob centers ~ N(0, spread^2) per dimension, sigma 1: at 300, two blobs'
#: squared distance (~1.15e7) dwarfs a blob's spread (~128), so k-means++
#: seeds one center per blob (the fit's recovery check needs that)
ML_SPREAD = 300.0
#: the CoresetTree stream: 64 batches of 2^16 points around 8 blob centers
TREE_BATCHES, TREE_BATCH, TREE_K, TREE_M = 64, 1 << 16, 8, 1024
#: the ml phase's http_events table: rows, services
ML_ROWS, ML_SERVICES = 1 << 23, 16
ML_KERNELS = [("kmeans", "px_kmeans_assign"), ("kmeans", "px_kmeans_lloyd"),
              ("kmeans", "px_kmeans_seed_step"), ("segment_reduce", "px_segment_count")]
#: 20 endpoint templates ({} an id segment), at most 5 literals a position
#: per depth, so RequestPathClustering keeps each as it is
ML_TEMPLATES = (
    [f"/{r}/{{}}" for r in ("users", "orders", "carts", "items", "reviews")]
    + [f"/api/{r}/{{}}" for r in ("users", "orders", "carts", "items", "reviews")]
    + ["/api/v1/users/{}/profile", "/api/v1/orders/{}/items", "/api/v2/carts/{}/lines",
       "/api/v2/items/{}/reviews", "/api/v3/reviews/{}/votes"]
    + ["/api/v1/users/{}/orders/{}", "/api/v1/orders/{}/items/{}",
       "/api/v2/carts/{}/lines/{}", "/api/v2/items/{}/reviews/{}",
       "/api/v3/shops/{}/carts/{}"])
#: 256 documents in 8 topics (their embeddings cluster by topic): a topic's
#: long phrase, two seeded words and a number
ML_TOPICS = ("checkout payment card declined retry gateway timeout refund",
             "login session token expired redirect identity provider cookie",
             "search results page latency ranking index shard replica",
             "inventory stock warehouse sync reservation backorder supplier",
             "shipping label carrier delay tracking customs manifest",
             "image upload resize thumbnail transcode bucket storage",
             "email notification bounce queue template digest unsubscribe",
             "recommendation model feature store embedding vector batch")
ML_WORDS = ("alpha", "beta", "gamma", "delta", "kappa", "sigma", "omega", "zeta",
            "north", "south", "east", "west", "red", "green", "blue", "amber")
TEMPLATES_SCRIPT = """
import px
df = px.DataFrame(table='http_events')
cl = df.groupby('service').agg(clustering=('req_path', px._build_request_path_clusters))
m = df.merge(cl, how='inner', left_on='service', right_on='service', suffixes=['', '_cl'])
m.endpoint = px._predict_request_path_cluster(m.req_path, m.clustering)
m = m.groupby('endpoint').agg(n=('latency', px.count))
px.display(m, 'out')
"""
KMEANS_SCRIPT = """
import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(model=('embedding', px._kmeans_fit))
px.display(df, 'out')
"""


def ml_blobs(dev, n: int, d: int, k: int, seed: int, spread: float):
    """n points of k gaussian blobs (sigma 1), made on the card from `seed`:
    → (x [n, d] float32, true centers [k, d])."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cent = torch.randn(k, d, generator=g, device=dev) * spread
    ids = torch.randint(0, k, (n,), generator=g, device=dev)
    return (cent[ids] + torch.randn(n, d, generator=g, device=dev)).contiguous(), cent


def kmeans_data(dev, n: int, d: int, k: int, seed: int, spread: float = 10.0):
    """The KM checks' seeded inputs: n points of k blobs (`ml_blobs`), the
    true centers moved by N(0, 0.25) as the centers, and weights in
    [0.5, 1.5): → (x [n, d], c [k, d], w [n])."""
    import torch

    x, cent = ml_blobs(dev, n, d, k, seed, spread)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    c = (cent + 0.5 * torch.randn(cent.shape, generator=g, device=dev)).contiguous()
    w = torch.rand(n, generator=g, device=dev) + 0.5
    return x, c, w


def _rel_err(a, b, scale, what: str) -> float:
    """max |a - b| / scale where `scale` is finite, after requiring NaN in
    the same places of a and b (a NaN error would pass any bound)."""
    import torch

    if not torch.equal(a.isnan(), b.isnan()):
        raise AssertionError(f"{what}: NaN in other places than the plain version's")
    keep = torch.isfinite(scale) & ~a.isnan()
    if not bool(keep.any()):
        return 0.0
    return float(((a - b).abs()[keep] / scale[keep].clamp_min(1e-30)).max())


def check_kmeans_kernels(dev) -> list[dict]:
    """KM1-KM3 held against their plain versions on the same CUDA tensors at
    the fit's shape (2^20 x 64 points, 64 centers, seeded blobs) and at edge
    cases.  The expansion |x|^2 - 2x.c + |c|^2 rounds relative to |x|^2 +
    |c|^2, so distances and p are compared to 1e-5 of that scale; ids must
    be equal except where the plain version's two nearest distances are
    within 1e-5 of it; NaN in the same places; wsum exactly with unit
    weights (and equal to the counts of KM1's ids, which KM2's assignment
    equals bit for bit); xsum to 1e-5 of each cell's sum of |w x|.  KM2
    gives the same bits twice.  The coreset's shapes (a leaf and a merge)
    are held as well as timed.  Returns the three kernel rows."""
    import torch

    from pixie_tpu_torch.ml import kmeans as km
    from pixie_tpu_torch.ops import kmeans as kops

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in float32
    torch.backends.cudnn.allow_tf32 = False

    def hold(label, x, c, w):
        n, d = x.shape
        k = c.shape[0]
        scale = (x * x).sum(1) + (c * c).sum(1).max()
        ids, mind = kops.assign(x, c)
        ids0, mind0 = kops.assign_plain(x, c)
        torch.cuda.synchronize()
        derr = _rel_err(mind, mind0, scale, f"KM1 {label}")
        if k > 1:
            two = torch.topk(kops.sq_dists_plain(x, c), 2, dim=1, largest=False).values
            tie = (two[:, 1] - two[:, 0]) <= 1e-5 * scale
        else:
            tie = torch.zeros(n, dtype=torch.bool, device=dev)
        bad_ids = int(((ids != ids0) & ~tie).sum())
        if derr > 1e-5 or bad_ids:
            raise AssertionError(f"KM1 {label}: distance err {derr} (of |x|^2 + |c|^2), "
                                 f"{bad_ids} ids differ outside near-ties")
        out = {"km1_dist_err_rel_scale": derr, "km1_near_ties": int(tie.sum()),
               "km1_max_abs_err": float((mind - mind0).nan_to_num().abs().max())}
        werr = 0.0
        counts = torch.bincount(ids, minlength=k).float()
        for wl, ww in (("unit", torch.ones_like(w)), ("weighted", w)):
            wsum, xsum = kops.lloyd_step(x, ww, c)
            again = kops.lloyd_step(x, ww, c)
            wsum0, xsum0 = kops.lloyd_step_plain(x, ww, c)
            absx = torch.zeros_like(xsum0).index_add_(0, ids0, (x * ww[:, None]).abs())
            torch.cuda.synchronize()
            if not (same_bits(wsum, again[0]) and same_bits(xsum, again[1])):
                raise AssertionError(f"KM2 {label} ({wl}): two calls differ")
            xerr = _rel_err(xsum, xsum0, absx, f"KM2 {label} ({wl}) xsum")
            if wl == "unit" and not (torch.equal(wsum, wsum0) and torch.equal(wsum, counts)):
                raise AssertionError(f"KM2 {label}: unit-weight wsum differs from the plain "
                                     "version's or from the counts of KM1's ids")
            werr = max(werr, _rel_err(wsum, wsum0, wsum0.abs(), f"KM2 {label} wsum"))
            if xerr > 1e-5 or werr > 1e-6:
                raise AssertionError(f"KM2 {label} ({wl}): xsum err {xerr}, wsum err {werr}")
            out[f"km2_xsum_err_{wl}"] = xerr
            out["km2_max_abs_err"] = max(out.get("km2_max_abs_err", 0.0),
                                         float((xsum - xsum0).nan_to_num().abs().max()))
        out["km2_wsum_err_weighted"] = werr
        mind_k = torch.full((n,), float("inf"), device=dev)
        mind_p = mind_k.clone()
        perr, pabs = 0.0, 0.0
        for j in range(min(k, 4)):
            p = kops.seed_step(x, w, c[j], mind_k)
            p0 = kops.seed_step_plain(x, w, c[j], mind_p)
            torch.cuda.synchronize()
            sc = ((x * x).sum(1) + (c[j] * c[j]).sum()) * w
            _rel_err(mind_k, mind_p, sc, f"KM3 {label} mind")
            perr = max(perr, _rel_err(p, p0, sc, f"KM3 {label} p"))
            pabs = max(pabs, float((p - p0).abs().max()))
        if perr > 1e-5:
            raise AssertionError(f"KM3 {label}: p err {perr} (of w (|x|^2 + |c|^2))")
        out.update({"km3_p_err_rel_scale": perr, "km3_max_abs_err": pabs})
        log(json.dumps({"check": f"KM1-KM3 {label}", "ok": True, **out}))
        return out

    data = functools.partial(kmeans_data, dev)
    # KM2's own plan (csrc/kmeans.cu): its tile, its capped grid, and the
    # centers one launch sums where shared memory holds the sums
    plan = kops._lloyd_plan(dev.index, ML_N, ML_D, ML_K)
    grid, tile = plan[2], plan[4]
    if grid * tile >= ML_N:
        raise AssertionError(f"KM2's grid of {grid} is not capped at n = {ML_N}")
    capped = grid * tile
    big_k = 40000
    big_rows = kops._lloyd_plan(dev.index, 4099, 64, big_k)[3]
    # edge cases: k = 1; more centers than a block's points; d not a
    # multiple of 4; n not a multiple of the block; d over one shared tile;
    # k over one register tile and KM2's shared memory in two center ranges;
    # n one short of and one past KM2's tile, and one past a tile for every
    # block of the capped grid; a k whose norms alone would fill a block's
    # shared memory (KM2 in many center ranges)
    for label, (n, d, k) in (("k=1", (1 << 16, 64, 1)),
                             ("k=300 > 256 points a block", (4099, 8, 300)),
                             ("d=13, n=2^16+3", ((1 << 16) + 3, 13, 7)),
                             ("d=150, k=200 (two KM2 center ranges)", (3001, 150, 200)),
                             ("k=129", (10007, 64, 129)),
                             ("k=9", (4099, 64, 9)), ("k=33", (4099, 64, 33)),
                             ("k=65", (4099, 64, 65)), ("d=65", (3001, 65, 64)),
                             (f"n={tile - 1}, one short of KM2's tile", (tile - 1, 64, 64)),
                             (f"n={tile + 1}, one past KM2's tile", (tile + 1, 64, 64)),
                             (f"n={tile + 1}, k=8", (tile + 1, 64, 8)),
                             (f"n={capped + 1}, past the capped grid", (capped + 1, 64, 64)),
                             (f"k={big_k} ({-(-big_k // big_rows)} KM2 center ranges)",
                              (4099, 64, big_k))):
        hold(label, *data(n, d, k, 40 + n % 97))
    # every point of every tile on one center
    x, c, w = data(1 << 14, 64, 64, 44)
    x = (c[5] + 0.1 * torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(45),
                                  device=dev)).contiguous()
    hold("skew: every point on center 5", x, c, w)
    # rows holding NaN: KM1 and KM2 take the first center (better()), KM3
    # folds NaN into mind and gives p = 0
    for label, (n, d, k) in (("NaN rows", (4099, 64, 64)), ("NaN rows, d=13", (3001, 13, 7))):
        x, c, w = data(n, d, k, 46)
        x[::97, 3] = float("nan")
        x[5] = float("nan")
        hold(label, x, c, w)
    # all-zero weights in a cluster: wsum 0, and the update keeps the center
    x, c, w = data(1 << 16, 64, 16, 47)
    ids, _ = kops.assign(x, c)
    w0 = torch.where(ids == 3, 0.0, w)
    wsum, _xsum = kops.lloyd_step(x, w0, c)
    newc = km._lloyd_centers(x, w0, c, 1)
    torch.cuda.synchronize()
    if float(wsum[3]) != 0.0 or not torch.equal(newc[3], c[3]):
        raise AssertionError("KM2: a zero-weight cluster moved its center")
    log(json.dumps({"check": "KM2 zero-weight cluster keeps its center", "ok": True}))

    def km2_bound(n, d, k):
        return bound(n * d * 4 + n * 4 + 2 * k * d * 4 + k * 4,
                     2.0 * n * k * d + 2.0 * n * (d + 1))

    def km3_bound(n, d):
        return bound(n * d * 4 + n * 16 + d * 4, 4.0 * n * d)

    def km1_bound(n, d, k):
        return bound(n * d * 4 + k * d * 4 + n * 12, 2.0 * n * k * d)

    def km1_times(x, c, reps):
        n, d = x.shape
        k = c.shape[0]
        return {"n": n, "d": d, "k": k, "ms": cuda_ms(lambda: kops.assign(x, c), reps),
                "device_ms": kernel_device_ms(lambda: kops.assign(x, c), reps),
                "host_us": host_us(lambda: kops.assign(x, c)),
                "plain_ms": cuda_ms(lambda: kops.assign_plain(x, c), 5),
                "bound_ms": km1_bound(n, d, k)[0],
                "library_ms": cuda_ms(lambda: torch.cdist(x, c).argmin(1), 5)}

    def seed_args(x, c, w):
        mind = torch.full((x.shape[0],), float("inf"), device=dev)
        kops.seed_step(x, w, c[0], mind)
        return mind

    # KM1-KM3 held and KM1 and KM2 timed at the coreset's shapes (a leaf:
    # 2^16 x 64, k = 8; a merge: 2,048 points), KM3 timed at the leaf
    small = {}
    for label, n in (("leaf", TREE_BATCH), ("merge", 2 * TREE_M)):
        xs_, cs_, ws_ = data(n, ML_D, TREE_K, 48)
        hold(f"coreset {label} (n={n}, d={ML_D}, k={TREE_K})", xs_, cs_, ws_)
        small[f"km1_{label}"] = km1_times(xs_, cs_, 20)
        small[f"km2_{label}"] = {
            "n": n, "d": ML_D, "k": TREE_K,
            "ms": cuda_ms(lambda: kops.lloyd_step(xs_, ws_, cs_), 20),
            "device_ms": kernel_device_ms(lambda: kops.lloyd_step(xs_, ws_, cs_), 20),
            "host_us": host_us(lambda: kops.lloyd_step(xs_, ws_, cs_)),
            "plain_ms": cuda_ms(lambda: kops.lloyd_step_plain(xs_, ws_, cs_), 5),
            "bound_ms": km2_bound(n, ML_D, TREE_K)[0]}
        if label == "leaf":
            mind_s = seed_args(xs_, cs_, ws_)
            small["km3_leaf"] = {
                "n": n, "d": ML_D,
                "ms": cuda_ms(lambda: kops.seed_step(xs_, ws_, cs_[1], mind_s), 20),
                "device_ms": kernel_device_ms(lambda: kops.seed_step(xs_, ws_, cs_[1], mind_s),
                                              20),
                "host_us": host_us(lambda: kops.seed_step(xs_, ws_, cs_[1], mind_s)),
                "plain_ms": cuda_ms(lambda: kops.seed_step_plain(xs_, ws_, cs_[1], mind_s), 5),
                "bound_ms": km3_bound(n, ML_D)[0]}
        log(json.dumps({"check": f"KM2/KM3 at the coreset's {label}",
                        **{k_: v for k_, v in small.items() if k_.endswith(label)}}))

    # the fit's shape
    x, c, w = data(ML_N, ML_D, ML_K, 41)
    main = hold(f"main (n=2^20, d={ML_D}, k={ML_K})", x, c, w)
    n, d, k = ML_N, ML_D, ML_K
    ids = kops.assign(x, c)[0]
    mind = seed_args(x, c, w)
    shape = {"n": n, "d": d, "k": k}
    common = {"route": "cuda", "source": "pixie_tpu_torch/csrc/kmeans.cu", "path": "ml"}
    rows = []
    b, by = km1_bound(n, d, k)
    km1 = km1_times(x, c, 20)
    rows.append({
        **common, "name": "kmeans_assign",
        "replaces": "pixie_tpu/ml/kmeans.py:21 _sq_dists (+ argmin / min :73, :112, :119)",
        "entry": ("kmeans", "px_kmeans_assign"), "max_abs_err": main["km1_max_abs_err"],
        "ms": km1["ms"], "plain_ms": km1["plain_ms"], "bound_ms": b, "bound_by": by,
        "library_ms": km1["library_ms"],
        "shape": {**shape, "device_ms": km1["device_ms"], "host_us": km1["host_us"],
                  "leaf": small["km1_leaf"], "merge": small["km1_merge"]}})
    b, by = km2_bound(n, d, k)

    def library_sums(ids_):
        torch.zeros(k, device=dev).index_add_(0, ids_, w)
        torch.zeros((k, d), device=dev).index_add_(0, ids_, x * w[:, None])

    rows.append({
        **common, "name": "kmeans_lloyd",
        "replaces": "pixie_tpu/ml/kmeans.py:61 _lloyd step (assign + segment_sum of w, x*w)",
        "entry": ("kmeans", "px_kmeans_lloyd"), "max_abs_err": main["km2_max_abs_err"],
        "ms": cuda_ms(lambda: kops.lloyd_step(x, w, c), 10),
        "plain_ms": cuda_ms(lambda: kops.lloyd_step_plain(x, w, c), 3),
        "bound_ms": b, "bound_by": by,
        # the same function in PyTorch calls: the assignment, then the two
        # float32 index_add_ of the reference's segment sums
        "library_ms": cuda_ms(lambda: library_sums(torch.cdist(x, c).argmin(1)), 5),
        "shape": {**shape, "device_ms": kernel_device_ms(lambda: kops.lloyd_step(x, w, c), 10),
                  "host_us": host_us(lambda: kops.lloyd_step(x, w, c)),
                  # the two index_add_ alone, given the ids (not the same
                  # function: no assignment)
                  "library_given_ids_ms": cuda_ms(lambda: library_sums(ids), 5),
                  "leaf": small["km2_leaf"], "merge": small["km2_merge"]}})
    b, by = km3_bound(n, d)
    rows.append({
        **common, "name": "kmeans_seed_step",
        "replaces": "pixie_tpu/ml/kmeans.py:30 _plusplus_init step",
        "entry": ("kmeans", "px_kmeans_seed_step"), "max_abs_err": main["km3_max_abs_err"],
        "ms": cuda_ms(lambda: kops.seed_step(x, w, c[1], mind), 20),
        "plain_ms": cuda_ms(lambda: kops.seed_step_plain(x, w, c[1], mind), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": {**shape,
                  "device_ms": kernel_device_ms(lambda: kops.seed_step(x, w, c[1], mind), 20),
                  "host_us": host_us(lambda: kops.seed_step(x, w, c[1], mind)),
                  "leaf": small["km3_leaf"]}})
    del x, c, w, ids, mind
    torch.cuda.empty_cache()
    return rows


def _endpoint_of(path: str) -> str:
    """The oracle's template of a path: all-digit segments become '*'."""
    return "/".join("*" if seg.isdigit() else seg for seg in path.split("/"))


def build_ml_table(ts):
    """http_events of ML_ROWS rows: 16 services, 200 request paths (10 ids
    in each of the 20 templates), exponential latency, and an embedding
    column of 256 _text_embedding strings (8 topics x 32 documents)."""
    from pixie_tpu_torch.types import DataType as DT, Relation
    from pixie_tpu_torch.udf.builtins import _text_embedding

    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("req_path", DT.STRING), ("latency", DT.FLOAT64),
                      ("embedding", DT.STRING))
    t = ts.create("http_events", rel, batch_rows=1 << 16)
    rng = np.random.default_rng(23)
    services = np.array([f"svc-{i}" for i in range(ML_SERVICES)])
    paths = np.array([tpl.format(*(str(1000 + 37 * j + 7 * s) for s in range(tpl.count("{}"))))
                      for tpl in ML_TEMPLATES for j in range(10)])
    words = np.random.default_rng(29).choice(ML_WORDS, (len(ML_TOPICS), 32, 2))
    embs = np.array([_text_embedding(f"{topic} {words[t, j, 0]} {words[t, j, 1]} {j}")
                     for t, topic in enumerate(ML_TOPICS) for j in range(32)], dtype=object)
    assert len(set(paths.tolist())) == 200 and len(set(embs.tolist())) == 256
    for off in range(0, ML_ROWS, 1 << 21):
        n = min(1 << 21, ML_ROWS - off)
        t.write({"time_": np.arange(off, off + n, dtype=np.int64) * 1000,
                 "service": services[rng.integers(0, ML_SERVICES, n)],
                 "req_path": paths[rng.integers(0, len(paths), n)],
                 "latency": rng.exponential(50.0, n),
                 "embedding": embs[rng.integers(0, len(embs), n)]})
    return t


class plain_fit_with_card_draws:
    """Context for the port's plain route (the CPU) replaying a fit the card
    made: every draw comes from the card's generator for the same seed, and
    the yielded dict records how close the fit came to a tie — "gap", the
    least gap between a point's two nearest centers in any assignment (of
    |x|^2 + |c|^2), and "margin", the least distance of a sample's r from a
    boundary of its cumulative sum (of the total).  Within 1e-5 of a tie,
    the card's rounding may break it the other way and take another path."""

    def __init__(self, dev):
        self.dev = dev
        self.margins: dict = {}

    def _gap(self, x, c):
        import torch

        from pixie_tpu_torch.ops import kmeans as kops

        if c.shape[0] > 1:
            two = torch.topk(kops.sq_dists_plain(x, c), 2, dim=1, largest=False).values
            g = float(((two[:, 1] - two[:, 0]) / ((x * x).sum(1) + (c * c).sum(1).max())).min())
            self.margins["gap"] = min(self.margins.get("gap", 1.0), g)

    def __enter__(self):
        import torch

        from pixie_tpu_torch.ml import kmeans as km
        from pixie_tpu_torch.ops import kmeans as kops

        self.saved = (km._uniforms, km._choice, kops.assign_plain, kops.lloyd_step_plain)
        uniforms, choice, assign, lloyd = self.saved

        def card_draws(gen, shape, device):
            return uniforms(km._generator(gen.initial_seed(), self.dev), shape,
                            self.dev).to(device)

        def choice_m(p, u):
            pc = torch.cumsum(p, 0, dtype=torch.float64)
            r = pc[-1] * (1 - u.double())
            i = torch.searchsorted(pc, r).clamp_max(len(pc) - 1)
            lo = torch.where(i > 0, pc[(i - 1).clamp_min(0)], 0.0)
            m = float((torch.minimum(r - lo, pc[i] - r) / pc[-1]).min())
            self.margins["margin"] = min(self.margins.get("margin", 1.0), m)
            return choice(p, u)

        def assign_m(x, c):
            self._gap(x, c)
            return assign(x, c)

        def lloyd_m(x, w, c):
            self._gap(x, c)
            return lloyd(x, w, c)

        km._uniforms, km._choice = card_draws, choice_m
        kops.assign_plain, kops.lloyd_step_plain = assign_m, lloyd_m
        return self.margins

    def __exit__(self, *exc):
        from pixie_tpu_torch.ml import kmeans as km
        from pixie_tpu_torch.ops import kmeans as kops

        km._uniforms, km._choice, kops.assign_plain, kops.lloyd_step_plain = self.saved
        return False


def record_assign_shapes(seen: dict):
    """Count, in `seen`, the (n, d, k) of every KM1 call on a CUDA tensor
    (each is one launch) until the returned function is called."""
    from pixie_tpu_torch.ops import kmeans as kops

    plain = kops.assign

    def assign(x, c):
        out = plain(x, c)
        if x.is_cuda:
            key = f"{x.shape[0]}x{x.shape[1]},k={c.shape[0]}"
            seen[key] = seen.get(key, 0) + 1
        return out

    kops.assign = assign

    def restore():
        kops.assign = plain

    return restore


def run_ml(dev) -> dict:
    """The ML path: kmeans_fit and CoresetTree on the card, then the
    service_endpoints pattern and _kmeans_fit from PxL text over an 8M-row
    table.  Launch counts are reset before the first step and read after the
    last; KM1's launches are also counted by shape."""
    import torch

    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ml import CoresetTree, kmeans_fit
    from pixie_tpu_torch.ml.coreset import kmeans_coreset
    from pixie_tpu_torch.ml.fit import KMeansFitUDA
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore

    out = {}
    km1_shapes: dict = {}
    restore = record_assign_shapes(km1_shapes)
    _build.reset_launches()

    # 1. kmeans_fit at the kernels' shape: determinism, recovery, launches
    x, cent = ml_blobs(dev, ML_N, ML_D, ML_K, 17, ML_SPREAD)
    torch.cuda.synchronize()
    fits, times, per_fit = [], [], []
    for _ in range(3):
        before = dict(_build.KERNELS["kmeans"].by_entry)
        t0 = time.perf_counter()
        fits.append(kmeans_fit(x, ML_K, max_iters=ML_ITERS, seed=5, device=dev))
        times.append(time.perf_counter() - t0)
        per_fit.append({e: v - before.get(e, 0)
                        for e, v in _build.KERNELS["kmeans"].by_entry.items()})
    want = {"px_kmeans_seed_step": ML_K - 1, "px_kmeans_lloyd": ML_ITERS, "px_kmeans_assign": 1}
    if any(p != want for p in per_fit):
        raise AssertionError(f"kmeans_fit launches {per_fit}, want {want} a fit")
    for f in fits[1:]:
        if not (np.array_equal(f[0], fits[0][0]) and np.array_equal(f[1], fits[0][1])):
            raise AssertionError(
                "kmeans_fit: two fits with one seed differ: "
                f"{int((f[0] != fits[0][0]).any(1).sum())} centers, "
                f"{int((f[1] != fits[0][1]).sum())} assignments")
    truth = cent.cpu().numpy()
    near = np.linalg.norm(truth[:, None, :] - fits[0][0][None], axis=2).min(1)
    if near.max() >= 0.5:
        raise AssertionError(f"kmeans_fit: a true center is {near.max()} sigma from the fit")
    out["fit"] = {"n": ML_N, "d": ML_D, "k": ML_K, "iters": ML_ITERS, "seconds": times,
                  "median_s": sorted(times)[1], "launches_per_fit": per_fit[0],
                  "max_center_err_sigma": float(near.max()), "deterministic": True}
    log(json.dumps({"phase": "ml.fit", "ok": True, **out["fit"]}))
    del x, cent, fits

    # 2. CoresetTree over a 4M-point stream, then a fit on its coreset
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    tcent = torch.randn(TREE_K, ML_D, generator=g, device=dev) * ML_SPREAD
    tree = CoresetTree(m=TREE_M, k=TREE_K, seed=3, device=dev)
    upd = []
    t_all = time.perf_counter()
    for _ in range(TREE_BATCHES):
        ids = torch.randint(0, TREE_K, (TREE_BATCH,), generator=g, device=dev)
        batch = (tcent[ids] + torch.randn(TREE_BATCH, ML_D, generator=g, device=dev)).cpu().numpy()
        t0 = time.perf_counter()
        tree.update(batch)
        upd.append(time.perf_counter() - t0)
    pts, w = tree.query()
    tree_s = time.perf_counter() - t_all
    c_tree, _ = kmeans_fit(pts, TREE_K, weights=w, seed=7, device=dev)
    d_true = np.linalg.norm(tcent.cpu().numpy()[:, None, :] - c_tree[None], axis=2).min(1)
    rms = d_true / math.sqrt(ML_D)  # per-dimension, in sigma
    stream = TREE_BATCHES * TREE_BATCH
    if rms.max() >= 1.0 or len(pts) > TREE_M or abs(float(w.sum()) / stream - 1) > 0.05:
        raise AssertionError(f"CoresetTree: centers {d_true} (per dimension {rms}), "
                             f"{len(pts)} points of weight {w.sum()} for {stream}")
    # row 17d: one leaf coreset of the stream's last batch with the
    # kernels, then on the plain routes
    ones = np.ones(len(batch), dtype=np.float32)

    def leaf():
        return kmeans_coreset(batch, ones, TREE_M, TREE_K, seed=3, device=dev)

    leaf_ms = cuda_ms(leaf, 5)
    with plain_routes():
        leaf_plain_ms = cuda_ms(leaf, 5)
        plain_pts, plain_w = leaf()
    if len(plain_pts) != TREE_M or abs(float(plain_w.sum()) / len(batch) - 1) > 0.05:
        raise AssertionError(f"leaf coreset on the plain routes: {len(plain_pts)} points of "
                             f"weight {plain_w.sum()}")
    out["tree"] = {"m": TREE_M, "k": TREE_K, "batches": TREE_BATCHES, "batch": TREE_BATCH,
                   "coreset_bound_ms": {"leaf": coreset_bound(TREE_BATCH, ML_D, TREE_K)[0],
                                        "merge": coreset_bound(2 * TREE_M, ML_D, TREE_K)[0]},
                   "leaf_coreset_ms": leaf_ms, "leaf_coreset_plain_ms": leaf_plain_ms,
                   "seconds": tree_s, "update_median_s": sorted(upd)[len(upd) // 2],
                   "update_max_s": max(upd), "levels": sorted(tree._levels),
                   "weight_over_stream": float(w.sum()) / stream,
                   "center_err_sigma": d_true.tolist(),
                   "center_err_sigma_per_dim_max": float(rms.max())}
    log(json.dumps({"phase": "ml.tree", "ok": True, **out["tree"]}))

    # 3. the service_endpoints pattern from PxL text
    t0 = time.perf_counter()
    ts = TableStore()
    table = build_ml_table(ts)
    out["data_s"] = time.perf_counter() - t0
    log(json.dumps({"phase": "ml.data", "rows": ML_ROWS, "seconds": out["data_s"]}))
    cols = _table_columns(table, ("service", "req_path", "embedding"))
    path_vals = table.dictionaries["req_path"].values()
    tmpl_names = sorted({_endpoint_of(p) for p in path_vals})
    tmpl_of = np.array([tmpl_names.index(_endpoint_of(p)) for p in path_vals])
    want_n = np.bincount(tmpl_of[cols["req_path"]], minlength=len(tmpl_names))

    def query(src):
        q = compile_pxl(src, ts.schemas())
        res = execute_plan(q.plan, ts, device=dev)["out"]
        torch.cuda.synchronize(dev)
        return res

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = query(TEMPLATES_SCRIPT)
        walls.append(time.perf_counter() - t0)
        got = dict(zip(res.decoded("endpoint"), np.asarray(res.columns["n"]).tolist()))
        if got != dict(zip(tmpl_names, want_n.tolist())):
            raise AssertionError(f"service endpoints: {got} != the oracle's counts")
    # row 18's bound: K1's count over gid * 256 + code, one feed of ML_ROWS
    # rows into ML_SERVICES x 256 cells
    out["endpoints"] = {"rows": ML_ROWS, "endpoints": len(got), "walls_s": walls,
                        "median_s": sorted(walls)[1],
                        "dicthist_bound_ms": bound(ML_ROWS * (4 + 1)
                                                   + 2 * ML_SERVICES * 256 * 8)[0]}
    log(json.dumps({"phase": "ml.endpoints", "ok": True, **out["endpoints"]}))

    # 4. _kmeans_fit per service, each model against the port's plain route
    # (the CPU) fitting the same group with the card's draws
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = query(KMEANS_SCRIPT)
        walls.append(time.perf_counter() - t0)
    svc_names = table.dictionaries["service"].values()
    emb_dict = table.dictionaries["embedding"]
    checked, near_tie, worst = 0, [], 0.0
    with plain_fit_with_card_draws(dev) as margins:
        for svc, model in zip(res.decoded("service"), res.decoded("model")):
            counts = np.bincount(cols["embedding"][cols["service"] == svc_names.index(svc)],
                                 minlength=256)
            nz = np.nonzero(counts > 0)[0]
            uda = KMeansFitUDA()
            uda.init(1, None, "cpu")
            margins.clear()
            want_c = np.asarray(json.loads(uda.fit_group(emb_dict.decode(nz), counts[nz]))
                                ["centroids"])
            if min(margins.values()) < 1e-5:
                near_tie.append({"service": svc, **margins})
                continue
            got_c = np.asarray(json.loads(model)["centroids"])
            err = float(np.abs(got_c - want_c).max()) if got_c.shape == want_c.shape else math.inf
            worst = max(worst, err)
            checked += 1
    if res.num_rows != ML_SERVICES or worst > 1e-4 or checked <= ML_SERVICES // 2:
        raise AssertionError(f"_kmeans_fit: {res.num_rows} models, {checked} checked "
                             f"(near ties: {near_tie}), worst centroid err {worst}")
    out["kmeans_query"] = {"rows": ML_ROWS, "models": res.num_rows, "walls_s": walls,
                           "median_s": sorted(walls)[1], "checked_models": checked,
                           "near_tie_models": near_tie, "max_centroid_err_vs_plain": worst}
    log(json.dumps({"phase": "ml.kmeans_query", "ok": True, **out["kmeans_query"]}))
    out["launches"] = read_launches("ml", ML_KERNELS)
    restore()
    km1 = out["launches"]["kmeans"].get("px_kmeans_assign", 0)
    if sum(km1_shapes.values()) != km1:
        raise AssertionError(f"KM1: {km1} launches, {km1_shapes} by shape")
    out["km1_launches_by_shape"] = dict(sorted(km1_shapes.items(), key=lambda kv: -kv[1]))
    log(json.dumps({"phase": "slice.ml", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"},
                    "launches": out["launches"]["kmeans"]}))
    return out


# ------------------------------------------------------ C1: the chain kernel

#: the `_dev` opcodes held against the plain interpreter at edge values:
#: (opcode, argument kinds) — B, I, F for bool, int64, float64
C1_OPS = ([(op, k) for op in ("add", "subtract", "multiply", "modulo", "floordiv", "divide",
                              "pow", "eq", "ne", "lt", "le", "gt", "ge")
           for k in ("II", "FF", "IF", "FI")]
          + [(op, k) for op in ("abs", "negate", "log", "log2", "log10", "exp", "sqrt", "ceil",
                                "floor", "round", "invert", "identity") for k in ("I", "F")]
          + [("bin", "II"), ("approx_eq", "FF"), ("eq", "BB"), ("ne", "BB"), ("and", "BB"),
             ("or", "BB"), ("not", "B"), ("select", "BII"), ("select", "BFF"),
             ("select", "BBB")])
C1_INT_EDGES = [-(2 ** 63), 2 ** 63 - 1, 0, -1, 1, -7, 7, 2, -2, 3, 10 ** 12, -(10 ** 12)]
C1_FLT_EDGES = [math.nan, math.inf, -math.inf, 0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -2.5, 1e-300,
                1e300, -7.25, 3.0, 1e-9, 2.0 ** 53 + 1]


def c1_edge_column(kind: str, n: int, rng, shift: int) -> np.ndarray:
    """n values with every edge value at the front, in an order shifted by
    `shift` so that two columns pair each edge with every other."""
    if kind == "B":
        return rng.random(n) < 0.5
    edges = np.array(C1_FLT_EDGES if kind == "F" else C1_INT_EDGES,
                     dtype=np.float64 if kind == "F" else np.int64)
    e = len(edges)
    v = (rng.normal(0, 100, n) if kind == "F"
         else rng.integers(-1000, 1000, n).astype(np.int64))
    idx = np.arange(e * e)
    v[: e * e] = edges[(idx // e ** shift) % e]
    return v


def c1_compare(label: str, got, want) -> float:
    """Bit for bit (a NaN equals a NaN); a float mismatch reports its ULP
    distance and stops the run."""
    import torch

    if got is None and want is None:
        return 0.0
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"C1 {label}: {got.dtype}{tuple(got.shape)} against "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.float64:
        g, w = got.cpu().numpy(), want.cpu().numpy()
        same = (np.isnan(g) & np.isnan(w)) | (g.view(np.int64) == w.view(np.int64))
        if not same.all():
            ulps = np.abs(g.view(np.int64)[~same].astype(object)
                          - w.view(np.int64)[~same].astype(object))
            raise AssertionError(f"C1 {label}: {int((~same).sum())} floats differ, up to "
                                 f"{max(ulps)} ulp")
        return 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"C1 {label}: differs from the plain interpreter")
    return 0.0


def chain_programs(dev):
    """The four chain programs of the C1 check at config #1's feed (16M
    rows): → [(label, kernel, feed columns, luts, scalars, limits, path)]."""
    import torch

    from pixie_tpu_torch.engine.executor import ChainKernel, GroupKey
    from pixie_tpu_torch.plan import Call, Column, FilterOp, LimitOp, MapOp, lit
    from pixie_tpu_torch.table.dictionary import Dictionary
    from pixie_tpu_torch.types import DataType as DT
    from pixie_tpu_torch.udf import registry
    from pixie_tpu_torch.udf.udf import CountUDA, MeanUDA, QuantileUDA

    rng = np.random.default_rng(21)
    n = FEED
    svc = Dictionary([f"svc-{i}" for i in range(N_SERVICES)])
    t_step = 600 * SEC // ROWS
    host = {"time_": np.arange(n, dtype=np.int64) * t_step,
            "service": rng.integers(0, N_SERVICES, n).astype(np.int32),
            "latency": rng.exponential(50.0, n),
            "status": rng.choice(np.array([200, 404, 500]), n, p=[0.85, 0.05, 0.10])}
    cols = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    all_types = {"time_": DT.TIME64NS, "service": DT.STRING, "latency": DT.FLOAT64,
                 "status": DT.INT64}
    not404 = FilterOp(expr=Call("not_equal", (Column("status"), lit(404))))
    out = []

    def luts_of(kern, extra=None):
        return {k: torch.as_tensor(v).to(dev) for k, v in {**kern.luts, **(extra or {})}.items()}

    # config #1: status != 404, group by service (dict) and status (int)
    types1 = {k: all_types[k] for k in ("service", "latency", "status")}
    kern = ChainKernel(types1, {"service": svc}, [not404], registry, "time_", dev)
    lut = kern.ctx.ec._add_lut(np.array([200, 404, 500], dtype=np.int64))
    keys = [GroupKey("service", "dict", N_SERVICES, DT.STRING, svc,
                     key_sval=kern.ctx.sym["service"]),
            GroupKey("status", "intdevice", 4, DT.INT64, src_name="status", lut_name=lut)]
    lat = kern.ctx.sym["latency"]
    kern.make_agg_step(keys, [("cnt", CountUDA(), None), ("avg_lat", MeanUDA(), lat),
                              ("p50", QuantileUDA(0.5), lat)], N_SERVICES * 4)
    out.append(("config #1 chain", kern, {k: cols[k] for k in types1}, luts_of(kern), {},
                None, "config1"))
    # config #2: + bin(time_, 10 s) and the window key with a runtime origin
    kern = ChainKernel(dict(all_types), {"service": svc}, [not404, MapOp(exprs=[
        ("time_", Call("bin", (Column("time_"), lit(10 * SEC)))),
        ("service", Column("service")), ("status", Column("status")),
        ("latency", Column("latency"))])], registry, "time_", dev)
    keys = [GroupKey("time_", "window", 64, DT.TIME64NS, width=10 * SEC,
                     key_sval=kern.ctx.sym["time_"], lut_name="__origin0"),
            GroupKey("service", "dict", N_SERVICES, DT.STRING, svc,
                     key_sval=kern.ctx.sym["service"])]
    lat = kern.ctx.sym["latency"]
    kern.make_agg_step(keys, [("cnt", CountUDA(), None), ("avg_lat", MeanUDA(), lat),
                              ("p50", QuantileUDA(0.5), lat)], 64 * N_SERVICES)
    out.append(("config #2 chain", kern, dict(cols), luts_of(kern),
                {"__origin0": int(host["time_"][0] // (10 * SEC))}, None, "config2"))
    # a select: a string-LUT predicate and a computed float column
    kern = ChainKernel(dict(all_types), {"service": svc}, [
        FilterOp(expr=Call("contains", (Column("service"), lit("svc-1")))),
        MapOp(exprs=[("time_", Column("time_")), ("service", Column("service")),
                     ("x", Call("add", (Call("multiply", (Column("latency"), lit(1e-3))),
                                        Call("divide", (Column("status"), lit(7)))))),
                     ("status", Column("status"))])], registry, "time_", dev)
    kern.make_output_step(["time_", "service", "x", "status"])
    out.append(("select chain", kern, dict(cols), luts_of(kern), {}, None, "select"))
    # two limits
    kern = ChainKernel(dict(all_types), {"service": svc}, [
        FilterOp(expr=Call("equal", (Column("status"), lit(500)))), LimitOp(n=1 << 20),
        FilterOp(expr=Call("greater", (Column("latency"), lit(10.0)))), LimitOp(n=100_000)],
        registry, "time_", dev)
    kern.make_output_step(["time_", "service", "latency", "status"])
    out.append(("two-limit chain", kern, dict(cols), luts_of(kern), {}, kern.init_limits(),
                "select"))
    return out


def chain_bound(kern, n: int) -> tuple[float, str]:
    """Bytes the chain must move: each feed column its programs read, once,
    and the mask, the group ids and each computed column written once."""
    from pixie_tpu_torch.ops import chain as c1

    read = {}
    for seg in kern.segments:
        for name, kind in zip(seg.binding.cols, seg.prog.col_kinds):
            if not name.startswith("__"):
                read[name] = c1.DTYPE[kind].itemsize
    last = kern.segments[-1].prog
    written = 1 + (4 if last.has_gid else 0) + sum(c1.DTYPE[k].itemsize
                                                   for k in last.out_kinds)
    return bound(n * (sum(read.values()) + written))


C1_DIVISORS = [1, 2, 3, 7, 10 ** 10, 2 ** 32 + 1, 2 ** 40, 2 ** 62, 2 ** 63 - 1, 0, -1, -3,
               -(2 ** 63)]


def check_chain_fused(dev, rng) -> None:
    """C1's shortened forms against the plain interpreter: FDIV_I, MOD_I
    and BIN_I by a constant (the multiply-high, and the plain division for
    d < 1) over int64 edge dividends; then a program of every fused
    instruction (MASK_CMP by each compare against a constant and a scalar,
    and the row bound; DICT_KEY; a bool column into the mask; SEARCH over a
    3-entry LUT, a count, and a 27-entry one, a binary search; WINDOW by
    10^10; more columns than CACHE holds) over a feed that ends mid-tile,
    with its columns aligned and one value past 16 bytes."""
    import torch

    from pixie_tpu_torch.ops import chain as c1

    n = 1 << 16
    for op in ("floordiv", "modulo", "bin"):
        for d in C1_DIVISORS:
            prog, _bnd = c1.op_program(op, [c1.I64, c1.I64], [None, d])
            x = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
            edges = [v for v in (-(2 ** 63), -(2 ** 63) + 1, -d - 1, -d, -d + 1, -1, 0, 1,
                                 d - 1, d, d + 1, 2 ** 63 - 1) if -(2 ** 63) <= v < 2 ** 63]
            x[: len(edges)] = edges
            cols = [torch.from_numpy(x).to(dev)]
            got = c1.run(prog, cols, [], [], n, dev)[2][0]
            c1_compare(f"{op} by {d}", got, c1.run_plain(prog, cols, [], [], n, dev)[2][0])
    cases = 0
    m = 3 * 2048 + 123
    luts = {"short": torch.tensor([200, 404, 500], dtype=torch.int64, device=dev),
            "long": torch.arange(-40, 40, 3, dtype=torch.int64, device=dev)}
    for kind in (c1.I64, c1.F64, c1.I32):
        for off in (0, 1):
            def column(k, lo=-50, hi=50):
                if k == c1.F64:
                    v = rng.normal(0, 40, m + off)
                    v[off: off + 6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0]
                elif k == c1.B:
                    v = rng.random(m + off) < 0.7
                else:
                    v = rng.integers(lo, hi, m + off).astype(np.int32 if k == c1.I32
                                                             else np.int64)
                    v[off: off + 3] = [7, -7, 0]
                return torch.from_numpy(v).to(dev)[off:]

            cols = {"x": column(kind), "y": column(c1.I64, 150, 550),
                    "code": column(c1.I32, -3, 20), "t": column(c1.I64, -(10 ** 12), 10 ** 12),
                    "b": column(c1.B)}
            lit = 3.0 if kind == c1.F64 else 7
            sfx = "_F" if kind == c1.F64 else "_I"
            for cmp in ("EQ", "NE", "LT", "LE", "GT", "GE"):
                b = c1.ProgramBuilder()
                b.row(); b.scalar("n_valid"); b.op("LT_I"); b.mask_and()
                b.col("x", kind); b.const(lit, kind); b.op(cmp + sfx); b.store()
                b.col("x", kind); b.const(lit, kind); b.op(cmp + sfx); b.mask_and()
                if kind != c1.F64:
                    b.col("x", kind); b.scalar("s"); b.op(cmp + sfx); b.store()
                b.col("b", c1.B); b.mask_and()
                b.col("code", c1.I32); b.dup(); b.const(0, c1.I64); b.op("GE_I")
                b.mask_and(); b.combine(16)
                b.col("t", c1.I64); b.window(10 ** 10, "origin"); b.combine(256)
                b.col("y", c1.I64); b.search("short"); b.store()
                b.col("y", c1.I64); b.search("long"); b.store()
                prog, bnd = b.finish(has_gid=True)
                scal = {"n_valid": m - 77, "s": 5, "origin": -3}
                args = ([cols[k] for k in bnd.cols], [luts[k] for k in bnd.luts],
                        [scal[k] for k in bnd.scalars], m, dev)
                got, want = c1.run(prog, *args), c1.run_plain(prog, *args)
                label = f"fused {cmp}{sfx} offset {off}"
                c1_compare(label + " mask", got[0], want[0])
                c1_compare(label + " gid", got[1], want[1])
                for j, (g, w) in enumerate(zip(got[2], want[2])):
                    c1_compare(f"{label} output {j}", g, w)
                cases += 1
    torch.cuda.synchronize()
    log(json.dumps({"check": "C1 fused instructions", "ok": True,
                    "divisions": 3 * len(C1_DIVISORS), "programs": cases}))


def k2_at_config2(dev, cols, chain_out) -> dict:
    """K2 at config #2's shape: the 16M-row feed's latency into config #2's
    chain's 1,024 window x service groups (the group ids and mask C1 just
    computed), on global atomics; held against update_plain at both NaN
    bins with 20% of the values NaN, then timed on the feed as it is."""
    import torch

    from pixie_tpu_torch.ops.sketch import LogHistogram, update_regime

    lh = LogHistogram()
    g, w = 64 * N_SERVICES, lh.width
    mask, gid = chain_out[0], chain_out[1]
    lat = cols["latency"]
    rng = np.random.default_rng(29)
    lat_nan = lat.clone()
    lat_nan[torch.from_numpy(rng.random(FEED) < 0.2).to(dev)] = float("nan")
    for nan_bin in (0, 1):
        a = lh.update(lh.init(g, dev), gid, lat_nan, mask, g, nan_bin)
        b = lh.update_plain(lh.init(g, dev), gid, lat_nan, mask, g, nan_bin)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"K2 at config #2's shape, NaN bin {nan_bin}: differs "
                                 "from update_plain")
    acc = lh.init(g, dev)
    cell = gid.long() * w + lh.bin_index(lat)
    weights = mask.float()
    b_ms, b_by = bound(FEED * 13 + 2 * g * w * 4, 2 * FEED)
    row = {
        "name": "loghist_update (config #2 shape)", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/loghist_update.cu",
        "replaces": "pixie_tpu/ops/sketch.py:118 LogHistogram.update (+ bin_index :101)",
        "entry": ("loghist_update", "px_loghist_update"), "path": "config2",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: lh.update(acc, gid, lat, mask, g), 20),
        "plain_ms": cuda_ms(lambda: lh.update_plain(acc, gid, lat, mask, g), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.bincount(cell, weights=weights,
                                                     minlength=g * w), 10),
        "shape": {"rows": FEED, "groups": g, "bins": w, "kept": int(mask.sum()),
                  "blocks": update_regime(g, w, torch.cuda.get_device_properties(
                      dev).shared_memory_per_block_optin),
                  "device_ms": kernel_device_ms(lambda: lh.update(acc, gid, lat, mask, g), 20),
                  "host_us": host_us(lambda: lh.update(acc, gid, lat, mask, g))},
    }
    log(json.dumps({"check": "K2 at config #2's shape, NaN bins 0 and 1", "ok": True,
                    "ms": row["ms"], "blocks": row["shape"]["blocks"]}))
    return row


def check_chain_kernel(dev) -> list[dict]:
    """C1 against its plain interpreter on the same CUDA tensors: every
    `_dev` opcode at edge values, the shortened forms (check_chain_fused),
    then four chain programs at a 16M-row feed (config #1's, config #2's, a
    select's, one with two limits), with n_valid < n and an all-false mask;
    timed beside the plain interpreter.  After config #2's chain, K2 at
    config #2's shape (k2_at_config2) on the group ids it computed."""
    import torch

    from pixie_tpu_torch.ops import chain as c1

    kinds = {"B": c1.B, "I": c1.I64, "F": c1.F64}
    rng = np.random.default_rng(23)
    n_ops = 1 << 16
    for op, ks in C1_OPS:
        for const in (False, True):
            consts = None
            if const and len(ks) > 1:
                consts = [None] * (len(ks) - 1) + [{"I": -3, "F": -2.5, "B": True}[ks[-1]]]
            prog, bnd = c1.op_program(op, [kinds[k] for k in ks], consts)
            cols = [torch.from_numpy(c1_edge_column(k, n_ops, rng, i)).to(dev)
                    for i, k in enumerate(ks) if f"a{i}" in bnd.cols]
            _m, _g, got = c1.run(prog, cols, [], [], n_ops, dev)
            _m, _g, want = c1.run_plain(prog, cols, [], [], n_ops, dev)
            torch.cuda.synchronize()
            c1_compare(f"{op}({ks}){' const' if consts else ''}", got[0], want[0])
    log(json.dumps({"check": "C1 opcodes", "ok": True, "cases": 2 * len(C1_OPS),
                    "rows": n_ops}))
    check_chain_fused(dev, rng)

    rows = []
    chains = chain_programs(dev)
    for label, kern, cols, luts, scalars, limits, path in chains:
        n = FEED

        def run(runner, n_valid=n, cols=cols, kern=kern, luts=luts, scalars=scalars,
                limits=limits):
            return kern.run_segments(kern.segments, cols, n, n_valid, -(2 ** 63),
                                     2 ** 63 - 1, limits, luts, scalars, runner=runner)

        for case, n_valid in (("", n), (", n_valid < n", n - 12345)):
            got, want = run(c1.run, n_valid), run(c1.run_plain, n_valid)
            torch.cuda.synchronize()
            c1_compare(label + case + " mask", got[0], want[0])
            c1_compare(label + case + " gid", got[1], want[1])
            for j, (g, w) in enumerate(zip(got[2], want[2])):
                c1_compare(f"{label}{case} output {j}", g, w)
            c1_compare(label + case + " consumed", got[3], want[3])
            log(json.dumps({"check": "C1 " + label + case, "ok": True,
                            "kept": int(got[0].sum()), "programs": len(kern.segments)}))
        b_ms, b_by = chain_bound(kern, n)
        if label == "config #2 chain":
            rows.append(k2_at_config2(dev, cols, run(c1.run)))
        rows.append({
            "name": f"chain C1 ({label})", "route": "cuda",
            "source": "pixie_tpu_torch/csrc/chain.cu",
            "replaces": "pixie_tpu/engine/executor.py:566-765 ChainKernel (_base_mask, "
                        "_apply_steps, key/value builders; groupby.py:21,73; eval.py:57)",
            "entry": C1, "path": path, "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: run(c1.run), 20),
            "plain_ms": cuda_ms(lambda: run(c1.run_plain), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a chain program
            "library_ms": None,
            "shape": {"rows": n, "programs": len(kern.segments),
                      "instructions": [len(s.prog.code) for s in kern.segments],
                      "depth": [s.prog.depth for s in kern.segments],
                      "device_ms": kernel_device_ms(lambda: run(c1.run), 10),
                      "host_us": host_us(lambda: run(c1.run), 100)},
        })
    # an all-false mask (every status 404 under config #1's filter)
    label, kern, cols, luts, scalars, limits, _p = chains[0]
    cols = dict(cols, status=torch.full_like(cols["status"], 404))
    got = kern.run_segments(kern.segments, cols, FEED, FEED, -(2 ** 63), 2 ** 63 - 1, None,
                            luts, {}, runner=c1.run)
    want = kern.run_segments(kern.segments, cols, FEED, FEED, -(2 ** 63), 2 ** 63 - 1, None,
                             luts, {}, runner=c1.run_plain)
    c1_compare("all-false mask", got[0], want[0])
    c1_compare("all-false gid", got[1], want[1])
    if bool(got[0].any()):
        raise AssertionError("C1: the all-false chain kept rows")
    log(json.dumps({"check": "C1 all-false mask", "ok": True}))
    return rows


def check_leaves(label: str, stats: dict) -> int:
    """Every chain value of the phase lowered into C1: no leaf."""
    leaves = int(stats.get("chain_leaves", -1))
    log(json.dumps({"phase": f"{label}.chain_leaves", "chain_leaves": leaves}))
    if leaves != 0:
        raise AssertionError(f"{label}: {leaves} chain leaves (want 0)")
    return leaves


# --------------------------------------------- config #2, #5, cluster stream


def config2_plan():
    """bench.http_plan(windowed_ns=10 s, quantiles=True) with the port's plan API."""
    from pixie_tpu_torch.plan import (AggExpr, AggOp, Call, Column, FilterOp, MapOp,
                                      MemorySinkOp, MemorySourceOp, Plan, lit)

    p = Plan()
    node = p.add(FilterOp(expr=Call("not_equal", (Column("status"), lit(404)))),
                 parents=[p.add(MemorySourceOp(table="http_events"))])
    node = p.add(MapOp(exprs=[("time_", Call("bin", (Column("time_"), lit(10 * SEC)))),
                              ("service", Column("service")), ("status", Column("status")),
                              ("latency", Column("latency"))]), parents=[node])
    agg = p.add(AggOp(groups=["time_", "service"], values=[
        AggExpr("cnt", "count", None), AggExpr("avg_lat", "mean", "latency"),
        AggExpr("p50", "p50", "latency"), AggExpr("p99", "p99", "latency")],
        windowed=True), parents=[node])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


class SketchOracle:
    """Per group: count, sum and the sketch histogram, accumulated over
    chunks in plain numpy (no code shared with the port's sketch)."""

    def __init__(self, ng: int):
        self.cnt = np.zeros(ng, np.int64)
        self.sum = np.zeros(ng)
        self.hist = np.zeros(ng * WIDTH, np.int64)
        self.ng = ng

    def add(self, key, lat) -> None:
        self.cnt += np.bincount(key, minlength=self.ng)
        self.sum += np.bincount(key, weights=lat, minlength=self.ng)
        x = np.maximum(lat.astype(np.float32), np.float32(MIN_VALUE))
        bins = np.clip(np.ceil(np.log(x) / np.float32(math.log(GAMMA))).astype(np.int64) + 1,
                       0, WIDTH - 1)
        bins[lat <= MIN_VALUE] = 0
        self.hist += np.bincount(key * WIDTH + bins, minlength=self.ng * WIDTH)

    def quantile(self, q: float) -> np.ndarray:
        """The sketch value of quantile q: the first bin whose running count
        reaches q of the group's total, as gamma^(idx - 1.5)."""
        cum = np.cumsum(self.hist.reshape(self.ng, WIDTH), axis=1)
        idx = np.minimum((cum < q * cum[:, -1:]).sum(axis=1), WIDTH - 1)
        return np.where(idx <= 0, 0.0, GAMMA ** (idx - 1.5))


def check_bins(label: str, got, want) -> int:
    """Quantiles in the oracle's sketch bin or the next; → exact bins."""
    ratio = np.asarray(got) / want
    in_bin = (np.isclose(ratio, 1.0, rtol=1e-12) | np.isclose(ratio, GAMMA, rtol=1e-12)
              | np.isclose(ratio, 1 / GAMMA, rtol=1e-12))
    if not in_bin.all():
        raise AssertionError(f"{label} outside the oracle's sketch bin: {np.asarray(got)[~in_bin]}")
    return int(np.isclose(ratio, 1.0, rtol=1e-12).sum())


def run_config2(dev, ts, table) -> dict:
    """Bench config #2 over the slice's 64M-row table: windowed p50 and p99
    per (10 s window, service), against a numpy oracle."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build

    plan = config2_plan()

    def query():
        r = execute_plan(plan, ts, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    _build.reset_launches()
    res = query()
    launches = read_launches("config #2", CONFIG2_KERNELS)
    if launches["loghist_quantile"] or launches["finalize"].get(F2[1]) != 1:
        raise AssertionError(f"config #2: want F2 once and no K3: {launches}")
    leaves = check_leaves("config2", res.exec_stats)
    cols = _table_columns(table, ("time_", "service", "latency", "status"))
    sel = cols["status"] != 404
    w = cols["time_"][sel] // (10 * SEC)
    w0 = int(w.min())
    key = (w - w0) * N_SERVICES + cols["service"][sel].astype(np.int64)
    ng = int(key.max()) + 1
    orc = SketchOracle(ng)
    orc.add(key, cols["latency"][sel])
    got_key = ((res.columns["time_"] // (10 * SEC) - w0) * N_SERVICES
               + res.columns["service"].astype(np.int64))
    if res.num_rows != int((orc.cnt > 0).sum()):
        raise AssertionError(f"config #2: {res.num_rows} groups, oracle {(orc.cnt > 0).sum()}")
    if not np.array_equal(res.columns["cnt"], orc.cnt[got_key]):
        raise AssertionError("config #2: counts differ from the oracle")
    if not np.allclose(res.columns["avg_lat"], (orc.sum / np.maximum(orc.cnt, 1))[got_key],
                       rtol=1e-9, atol=0):
        raise AssertionError("config #2: means differ from the oracle beyond rtol 1e-9")
    exact = {q: check_bins(f"config #2 {q}", res.columns[q], orc.quantile(v)[got_key])
             for q, v in (("p50", 0.5), ("p99", 0.99))}
    log(json.dumps({"phase": "config2.oracle", "ok": True, "groups": res.num_rows,
                    "exact_bins": exact}))
    routes = stream_and_warm(query, "config #2", with_profile=True)
    for k in ("profile_stream", "profile_warm"):
        routes[k]["top"] = routes[k]["top"][:8]
    out = {"rows": ROWS, "groups": res.num_rows, "launches": launches, "chain_leaves": leaves,
           **routes, "rows_per_s": ROWS / routes["warm_median_s"],
           "stream_rows_per_s": ROWS / routes["stream_median_s"]}
    log(json.dumps({"phase": "slice.config2", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


#: bench_config5's script and shape (bench.py:333-420, --stream-rows default)
CONFIG5_SCRIPT = """
df = px.DataFrame(table='http_events').stream()
df = df.rolling('10s').agg(cnt=('latency', px.count), p50=('latency', px.p50))
px.display(df, 'win')
"""
CONFIG5_ROWS = 100_000_000
CONFIG5_CHUNK = 1 << 21


def run_config5(dev) -> dict:
    """bench_config5 on the card: a writer appends 2^21-row chunks (seed 3)
    while a poller thread polls the windowed StreamQuery on a 200 ms
    cadence; every 10 s window is emitted exactly once with the oracle's
    count and p50 bin."""
    import threading

    import torch

    from pixie_tpu_torch.engine.stream import stream_pxl
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    ts = TableStore()
    ts.create("http_events", Relation.of(("time_", DT.TIME64NS), ("service_id", DT.INT64),
                                         ("latency", DT.FLOAT64)),
              batch_rows=1 << 16, max_bytes=1 << 36)
    sq = stream_pxl(CONFIG5_SCRIPT, ts, device=dev)
    rng = np.random.default_rng(3)
    svc = rng.integers(0, N_SERVICES, CONFIG5_CHUNK)
    lat = rng.exponential(50.0, CONFIG5_CHUNK)
    t = ts.table("http_events")
    emitted, polls, errors = [], [0], []
    stop = threading.Event()

    def poller():
        try:
            torch.cuda.set_device(dev)
            while not stop.is_set():
                got = sq.poll()
                polls[0] += 1
                if got:
                    emitted.append(got["win"])
                if not sq.lagging():
                    stop.wait(0.2)
        except BaseException as e:  # surfaced by the writer below
            errors.append(e)

    rows = CONFIG5_ROWS
    t_step = 600 * SEC // rows
    th = threading.Thread(target=poller, daemon=True)
    _build.reset_launches()
    written = 0
    t0 = time.perf_counter()
    th.start()
    while written < rows:
        n = min(CONFIG5_CHUNK, rows - written)
        t.write({"time_": np.arange(written, written + n, dtype=np.int64) * t_step,
                 "service_id": svc[:n], "latency": lat[:n]})
        written += n
    stop.set()
    th.join()
    if errors:
        raise errors[0]
    fin = sq.close()
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    if fin:
        emitted.append(fin["win"])
    launches = read_launches("config #5", CONFIG5_KERNELS)
    leaves = check_leaves("config5", sq.stats)
    # oracle: the replayed chunk's latencies under each chunk's times
    orc = SketchOracle(600 * SEC // (10 * SEC) + 1)
    for off in range(0, rows, CONFIG5_CHUNK):
        n = min(CONFIG5_CHUNK, rows - off)
        orc.add((np.arange(off, off + n, dtype=np.int64) * t_step) // (10 * SEC), lat[:n])
    wins = np.concatenate([r.columns["time_"] for r in emitted])
    cnts = np.concatenate([r.columns["cnt"] for r in emitted])
    p50 = np.concatenate([r.columns["p50"] for r in emitted])
    if len(np.unique(wins)) != len(wins):
        raise AssertionError("config #5: a window was emitted twice")
    idx = wins // (10 * SEC)
    if set(idx.tolist()) != set(np.nonzero(orc.cnt)[0].tolist()):
        raise AssertionError("config #5: emitted windows differ from the oracle's")
    if int(cnts.sum()) != rows or not np.array_equal(cnts, orc.cnt[idx]):
        raise AssertionError("config #5: window counts differ from the oracle")
    exact = check_bins("config #5 p50", p50, orc.quantile(0.5)[idx])
    out = {"rows": rows, "chunk": CONFIG5_CHUNK, "windows": int(len(wins)),
           "polls": polls[0], "seconds": secs, "rows_per_s": rows / secs,
           "p50_exact_bins": exact, "feeds": sq.stats.get("feeds", 0),
           "h2d_bytes": sq.stats.get("h2d_bytes", 0), "chain_leaves": leaves,
           "launches": launches}
    log(json.dumps({"phase": "slice.config5", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


CLUSTER_STREAM_SCRIPT = """
df = px.DataFrame(table='http_events').stream()
df = df[df.status != 404]
df = df.rolling('10s').groupby('service').agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'win')
"""
CLUSTER_STREAM_CHUNKS = 16


def _emitted_frame(results) -> dict:
    """(window, service) → (count, mean, p50) over a stream's emissions."""
    out = {}
    for r in results:
        svc = r.decoded("service")
        for i in range(r.num_rows):
            k = (int(r.columns["time_"][i]), svc[i])
            if k in out:
                raise AssertionError(f"cluster stream: group {k} emitted twice")
            out[k] = (int(r.columns["cnt"][i]), float(r.columns["avg_lat"][i]),
                      float(r.columns["p50"][i]))
    return out


def run_cluster_stream(dev) -> dict:
    """ClusterStreamQuery over 8 agent stores (config #4's 2M rows each,
    written in 16 chunks with a poll after each): the emitted union equals
    one StreamQuery over a store holding every agent's rows."""
    import torch

    from pixie_tpu_torch.engine.stream import stream_pxl
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.parallel.streaming import ClusterStreamQuery
    from pixie_tpu_torch.table import TableStore

    rows_each = CONFIG4_ROWS // CONFIG4_AGENTS
    stores, gens = {}, {}
    for a in range(CONFIG4_AGENTS):
        ts = TableStore()
        t, _g = build_http_table(ts, 0)
        gens[f"pem{a}"] = HttpRows(t, rows_each)
        stores[f"pem{a}"] = ts
    union = TableStore()
    ut, _g = build_http_table(union, 0)
    ugens = [HttpRows(ut, rows_each) for _ in range(CONFIG4_AGENTS)]
    cs = ClusterStreamQuery(LocalCluster(stores, device=dev), CLUSTER_STREAM_SCRIPT)
    sq = stream_pxl(CLUSTER_STREAM_SCRIPT, union, device=dev)
    step = rows_each // CLUSTER_STREAM_CHUNKS
    emitted, union_emitted, poll_s = [], [], []
    _build.reset_launches()
    t0 = time.perf_counter()
    for _k in range(CLUSTER_STREAM_CHUNKS):
        for g in gens.values():
            g.write(step)
        tp = time.perf_counter()
        got = cs.poll()
        torch.cuda.synchronize(dev)
        poll_s.append(time.perf_counter() - tp)
        if got:
            emitted.append(got["win"])
    fin = cs.close()
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    if fin:
        emitted.append(fin["win"])
    launches = read_launches("cluster stream", CLUSTER_STREAM_KERNELS)
    leaves = check_leaves("cluster_stream", cs.stats)
    for _k in range(CLUSTER_STREAM_CHUNKS):
        for g in ugens:
            g.write(step)
        got = sq.poll()
        if got:
            union_emitted.append(got["win"])
    fin = sq.close()
    if fin:
        union_emitted.append(fin["win"])
    a, b = _emitted_frame(emitted), _emitted_frame(union_emitted)
    if a.keys() != b.keys():
        raise AssertionError(f"cluster stream: {len(a)} groups, the union stream {len(b)}")
    for k, (c, m, p) in a.items():
        c2, m2, p2 = b[k]
        if c != c2 or not math.isclose(m, m2, rel_tol=1e-9) or not (
                p == p2 or math.isclose(p / p2, GAMMA, rel_tol=1e-12)
                or math.isclose(p2 / p, GAMMA, rel_tol=1e-12)):
            raise AssertionError(f"cluster stream: group {k}: {(c, m, p)} against "
                                 f"{(c2, m2, p2)}")
    if sum(c for c, _m, _p in a.values()) != int(
            sum((_table_columns(t_.table("http_events"), ("status",))["status"] != 404).sum()
                for t_ in stores.values())):
        raise AssertionError("cluster stream: counts do not sum to the rows kept")
    out = {"agents": CONFIG4_AGENTS, "rows": CONFIG4_ROWS, "polls": CLUSTER_STREAM_CHUNKS,
           "groups": len(a), "seconds": secs, "rows_per_s": CONFIG4_ROWS / secs,
           "poll_median_s": sorted(poll_s)[len(poll_s) // 2], "chain_leaves": leaves,
           "launches": launches}
    log(json.dumps({"phase": "slice.cluster_stream", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


# ------------------------------------------------------- G1 and the batch phase

#: the reference load harness's four dashboard scripts over one hot table
#: (pixie_tpu/serving/load_bench.py:377-405 BATCH_SCRIPTS, as text)
BATCH_SCRIPTS = [
    """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df[df.latency > 10.0]
df = df.groupby('service').agg(cnt=('latency', px.count),
                               mx=('latency', px.max))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df.groupby('status').agg(p50=('latency', px.p50),
                              p99=('latency', px.p99))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df[df.status == 200]
df = df.groupby('service').agg(avg=('latency', px.mean),
                               mn=('latency', px.min))
px.display(df, 'out')
""",
]
#: each script's group keys, for comparing results as sorted frames
BATCH_KEYS = [["service", "status"], ["service"], ["status"], ["service"]]
#: the batched arm runs every member's partial step in G1 (one agent: no M1;
#: the merger finalizes on the host)
#: one agent: the gang's states read back through P1
BATCH_KERNELS = [("gang", "px_gang_partial"), P1]
#: the batch phase's clients: 4 threads per script, 8 queries each
BATCH_CLIENTS_PER_SCRIPT = 4
BATCH_QUERIES = 8
#: G1's global-atomics member: grouped by an int key of 2^20 values
GANG_BIG_KEYS = 1 << 20


def gang_feed(dev, ts):
    """The four BATCH_SCRIPTS fused and split as LocalCluster does, their
    partial aggregates prepared as the executor's gang prepares them
    (`_agg_setup`), over the table's first 16M-row feed: → (fresh() → one
    state per member, members(states) → the gang's members over the feed,
    per_sink(states): each member's C1 and K1/K2 launches on the feed, the
    feed's columns, n_valid)."""
    import torch

    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine.executor import PlanExecutor, _time_bounds
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.plan import AggOp
    from pixie_tpu_torch.serving import batching

    cl = LocalCluster({"pem0": ts}, device=dev)
    qs = [compile_pxl(s, cl.schemas()) for s in BATCH_SCRIPTS]
    fused, _map = batching.fuse_members([(f"q{i}", q.plan) for i, q in enumerate(qs)],
                                        cl.schemas())
    ap = cl.planner.plan(fused).agent_plans["pem0"]
    ex = PlanExecutor(ap, ts, None, device=dev)
    setups = [ex._agg_setup(op) for op in ap.topo_sorted() if isinstance(op, AggOp)]
    names: list = []
    for s in setups:
        names.extend(n for n in s.names if n not in names)
    cols, n_valid = next(iter(ex._feed(setups[0].src, names, setups[0].cap)))
    t_lo, t_hi = _time_bounds(setups[0].head)
    luts = [{k: torch.as_tensor(v).to(dev) for k, v in s.kern.luts.items()} for s in setups]

    def fresh():
        return [{name: uda.init(s.num_groups, in_dt, dev) for name, uda, in_dt in s.init_specs}
                for s in setups]

    def members(states, feed=None, nan_bin=1):
        feed = cols if feed is None else feed
        out = [s.kern.gang_member(feed, n_valid, t_lo, t_hi, lut, st, s.origins)
               for s, lut, st in zip(setups, luts, states)]
        for m in out:
            for leaf in m.leaves:
                leaf.nan_bin = nan_bin
        return out

    def per_sink(states):
        for s, lut, st in zip(setups, luts, states):
            s.step(cols, n_valid, t_lo, t_hi, None, lut, st, s.origins)

    return fresh, members, per_sink, cols, n_valid


def gang_big_member(dev, cols, n_valid, rng):
    """A member of GANG_BIG_KEYS groups (count, a float64 sum and max of
    latency, an int64 min of status) over the same feed, keyed by an int
    column of 2^20 values encoded against its sorted values (the executor's
    int-key route): its states do not fit a block, so it takes global
    atomics.  → members(states), fresh()."""
    import torch

    from pixie_tpu_torch.ops import chain as c1
    from pixie_tpu_torch.ops import gang as g1
    from pixie_tpu_torch.ops.groupby import _identity_for

    n = next(iter(cols.values())).shape[0]
    conn = torch.from_numpy(rng.integers(0, GANG_BIG_KEYS, n)).to(dev)
    keys = torch.arange(GANG_BIG_KEYS, dtype=torch.int64, device=dev)
    b = c1.ProgramBuilder()
    b.row(); b.scalar("n_valid"); b.op("LT_I"); b.mask_and()
    b.col("status", c1.I64); b.const(404, c1.I64); b.op("NE_I"); b.mask_and()
    b.col("conn", c1.I64); b.search("keys"); b.combine(GANG_BIG_KEYS)
    prog, bnd = b.finish(has_gid=True)
    src = {**cols, "conn": conn}
    g = GANG_BIG_KEYS

    def fresh():
        return {"cnt": torch.zeros(g, dtype=torch.int64, device=dev),
                "sum": torch.zeros(g, dtype=torch.float64, device=dev),
                "mx": torch.full((g,), _identity_for(torch.float64, "max"),
                                 dtype=torch.float64, device=dev),
                "mn": torch.full((g,), _identity_for(torch.int64, "min"),
                                 dtype=torch.int64, device=dev)}

    def member(st):
        return g1.Member(prog, [src[k] for k in bnd.cols], [keys], [n_valid], g, [
            g1.Leaf("count", st["cnt"]), g1.Leaf("sum", st["sum"], cols["latency"]),
            g1.Leaf("max", st["mx"], cols["latency"]), g1.Leaf("min", st["mn"], cols["status"])])

    return member, fresh


def gang_bound(members: list, n: int) -> tuple[float, str]:
    """Bytes G1 must move over one feed: each distinct feed column the
    members read (their programs' inputs and their leaves' values), once,
    and each state leaf written once."""
    import torch

    cols: dict[int, int] = {}
    for m in members:
        for c in m.cols:
            cols[c.data_ptr()] = c.element_size() * n
        for leaf in m.leaves:
            if isinstance(leaf.value, torch.Tensor):
                cols[leaf.value.data_ptr()] = leaf.value.element_size() * n
    states = {leaf.state.data_ptr(): leaf.state.numel() * leaf.state.element_size()
              for m in members for leaf in m.leaves}
    return bound(sum(cols.values()) + sum(states.values()))


def gang_compare(label: str, got: list, want: list) -> float:
    """Two gangs' states leaf by leaf: float64 sums to rtol 1e-12 (atomic
    order), every other leaf exactly; → the largest float64 sum difference."""
    import torch

    err = 0.0
    for mg, mw in zip(got, want):
        for lg, lw in zip(mg.leaves, mw.leaves):
            a, b = lg.state, lw.state
            if a.dtype.is_floating_point and lg.op in ("sum", "sumsq"):
                # (a NaN value makes its group's sum NaN on both routes)
                ok = torch.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
                err = max(err, float((a - b).nan_to_num().abs().max()))
            else:
                ok = same_bits(a, b)
            if not ok:
                raise AssertionError(f"G1 {label}: {lg.op} leaf ({a.dtype}, "
                                     f"{tuple(a.shape)}) differs")
    return err


def check_gang_kernel(dev, ts) -> list[dict]:
    """G1 against its plain version and against the per-sink route (each
    member's C1 and K1/K2 launches) on one 16M-row feed of the 64M-row
    table, with the four BATCH_SCRIPTS members (their states in shared
    memory), on the same feed with its latencies 20% NaN at both NaN bins,
    with a member of 2^20 groups added (global atomics), and past one
    launch's table (24 members: two launches); timed beside both, with its
    device time and its host microseconds a call."""
    import torch

    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.ops import gang as g1

    fresh, members, per_sink, cols, n_valid = gang_feed(dev, ts)
    n = next(iter(cols.values())).shape[0]
    a, b, c = fresh(), fresh(), fresh()
    g1.run(members(a), n, dev)
    g1.run_plain(members(b), n, dev)
    per_sink(c)
    torch.cuda.synchronize()
    err = gang_compare("against its plain version", members(a), members(b))
    err = max(err, gang_compare("against the per-sink route", members(a), members(c)))
    offs, acc = g1.plan_shared(members(a))
    if None in offs:
        raise AssertionError(f"G1: a BATCH_SCRIPTS member missed shared memory: {offs}")
    log(json.dumps({"check": "G1 BATCH_SCRIPTS members", "ok": True, "rows": n,
                    "members": len(offs), "shared_bytes": acc, "max_abs_err": err}))
    lat = cols["latency"].clone()
    lat[torch.rand(n, device=dev, generator=torch.Generator(dev).manual_seed(5)) < 0.2] = \
        float("nan")
    nan_feed = {**cols, "latency": lat}
    for nan_bin in (0, 1):
        a, b = fresh(), fresh()
        g1.run(members(a, nan_feed, nan_bin), n, dev)
        g1.run_plain(members(b, nan_feed, nan_bin), n, dev)
        torch.cuda.synchronize()
        e = gang_compare(f"20% NaN, NaN bin {nan_bin}", members(a, nan_feed, nan_bin),
                         members(b, nan_feed, nan_bin))
        log(json.dumps({"check": f"G1 BATCH_SCRIPTS members, 20% NaN, NaN bin {nan_bin}",
                        "ok": True, "max_abs_err": e}))
    big, big_fresh = gang_big_member(dev, cols, n_valid, np.random.default_rng(31))
    sa, sb = (big_fresh(), fresh()), (big_fresh(), fresh())
    for (bs, st), run in ((sa, g1.run), (sb, g1.run_plain)):
        run([big(bs)] + members(st), n, dev)
    torch.cuda.synchronize()
    mixed = [big(sa[0])] + members(sa[1])
    err_big = gang_compare("with a 2^20-group member", mixed, [big(sb[0])] + members(sb[1]))
    offs_big, _acc = g1.plan_shared(mixed)
    if offs_big[0] is not None or None in offs_big[1:]:
        raise AssertionError(f"G1: the 2^20-group member took shared memory: {offs_big}")
    st = fresh()
    mixed_ms = cuda_ms(lambda: g1.run([big(sa[0])] + members(st), n, dev), 10)
    log(json.dumps({"check": "G1 with a 2^20-group member", "ok": True,
                    "max_abs_err": err_big, "kernel_ms": mixed_ms,
                    "bound_ms": gang_bound(mixed, n)[0]}))
    # past one launch's table: the four members six times over, 24 members
    states = [fresh() for _ in range(6)]
    plain = [fresh() for _ in range(6)]
    before = _build.KERNELS["gang"].launches
    g1.run([m for st_ in states for m in members(st_)], n, dev)
    past_launches = _build.KERNELS["gang"].launches - before
    g1.run_plain([m for st_ in plain for m in members(st_)], n, dev)
    torch.cuda.synchronize()
    err_past = gang_compare("past one launch's table", [m for st_ in states for m in members(st_)],
                            [m for st_ in plain for m in members(st_)])
    if past_launches != 2:
        raise AssertionError(f"G1 past capacity: {past_launches} launches for 24 members")
    log(json.dumps({"check": "G1 past one launch's table (24 members)", "ok": True,
                    "launches": past_launches, "max_abs_err": err_past}))
    st = fresh()
    ms = members(st)
    b_ms, b_by = gang_bound(ms, n)
    main = {"ms": cuda_ms(lambda: g1.run(ms, n, dev), 20),
            "device_ms": kernel_device_ms(lambda: g1.run(ms, n, dev), 10),
            # the wrapper's own host time a call, its members built once
            "host_us": host_us(lambda: g1.run(ms, n, dev)),
            # the yardstick: the same work as each member's C1 and K1/K2 launches
            "per_sink_ms": cuda_ms(lambda: per_sink(st), 20), "bound_ms": b_ms}
    log(json.dumps({"check": "G1 BATCH_SCRIPTS members timed", "ok": True, **main}))
    return [{
        "name": "gang G1 (the four BATCH_SCRIPTS members)", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/gang.cu",
        "replaces": "pixie_tpu/engine/executor.py:2807 _multi_partial_agg (fused_fn :2852)",
        "entry": ("gang", "px_gang_partial"), "path": "batch",
        "max_abs_err": max(err, err_big, err_past), "ms": main["ms"],
        "plain_ms": cuda_ms(lambda: g1.run_plain(members(st), n, dev), 3, warmup=1),
        "per_sink_ms": main["per_sink_ms"], "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a gang
        "library_ms": None,
        "shape": {"rows": n, "members": len(offs), "union_columns": sorted(cols),
                  "device_ms": main["device_ms"], "host_us": main["host_us"],
                  "with_2_20_group_member_ms": mixed_ms},
    }]


# ---------------------------------------- F1, F2 and P1 (the device finalize)

#: the one-feed phase: config #1 at one 16M-row feed and at the 1M-row
#: interactive shape
ONE_FEED_ROWS = 1 << 24
INTERACTIVE_ROWS = 1 << 20
#: the per-feed route's kernels, none of which a one-feed query launches
ROUTE_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                 ("segment_reduce", "px_segment_sum_f64"),
                 ("loghist_update", "px_loghist_update"), K3]
#: F2's bandwidth shape: 8 states of 2^16 groups, config #1's tree
F2_WIDE_GROUPS = 1 << 16
F2_WIDE_STATES = 8
#: P1's large state: 2^20 groups of count, mean (f64 sum, count) and seen
P1_WIDE_GROUPS = 1 << 20


class AggFeeds:
    """A plan's one aggregate prepared as the executor prepares it
    (`_agg_setup`) over the table's feeds (served from the tier and the
    cache after the slice phase): F1 and its plain version over feed i, the
    per-feed route (C1, K1, K2) into a state, and K3 on a state's sketches."""

    def __init__(self, dev, ts, plan):
        import torch

        from pixie_tpu_torch.engine.executor import PlanExecutor, _time_bounds
        from pixie_tpu_torch.ops import finalize as fin
        from pixie_tpu_torch.plan import AggOp

        self.dev = dev
        ex = PlanExecutor(plan, ts, device=dev)
        (op,) = [o for o in plan.topo_sorted() if isinstance(o, AggOp)]
        self.s = s = ex._agg_setup(op)
        self.feeds = list(ex._feed(s.src, s.names, s.cap))
        self.t_lo, self.t_hi = _time_bounds(s.head)
        self.luts = {k: torch.as_tensor(v).to(dev) for k, v in s.kern.luts.items()}
        self.rt = {name: uda.reduce_ops() for name, uda, _vb in s.udas}
        self.finals = fin.finals_of((name, uda) for name, uda, _vb in s.udas)

    def init(self, device):
        return {name: uda.init(self.s.num_groups, dt, device)
                for name, uda, dt in self.s.init_specs}

    def n(self, i: int) -> int:
        return next(iter(self.feeds[i][0].values())).shape[0]

    def f1_layout(self) -> list:
        """[block width, R, sketch private, combine] of F1's member pass
        here (ops/gang.py plan_f1_pass)."""
        from pixie_tpu_torch.ops import gang as g1

        pp = g1.plan_f1_pass(self.member(0, self.init(self.dev)))
        return [pp.block, pp.rows_per_thread, pp.hist_shared, pp.combine]

    def add_feed(self, i: int, rows: int | None = None, nan_share: float = 0.0) -> int:
        """A feed made from feed i: its first `rows` rows, its latencies
        `nan_share` NaN (seeded); → its index."""
        import torch

        cols, n_valid = self.feeds[i]
        rows = self.n(i) if rows is None else rows
        cols = {k: v[:rows] for k, v in cols.items()}
        if nan_share:
            lat = cols["latency"].clone()
            gen = torch.Generator(self.dev).manual_seed(6)
            lat[torch.rand(rows, device=self.dev, generator=gen) < nan_share] = float("nan")
            cols["latency"] = lat
        self.feeds.append((cols, min(n_valid, rows)))
        return len(self.feeds) - 1

    def member(self, i: int, state):
        cols, n_valid = self.feeds[i]
        return self.s.kern.gang_member(cols, n_valid, self.t_lo, self.t_hi, self.luts, state,
                                       self.s.origins)

    def f1(self, i: int):
        """F1 over feed i, its plan cached as the executor caches it."""
        from pixie_tpu_torch.engine.executor import f1_key
        from pixie_tpu_torch.ops import finalize as fin

        return fin.fused_partial_finalize(lambda st: self.member(i, st), self.init, self.rt,
                                          self.finals, self.n(i), self.dev,
                                          f1_key(self.s.num_groups, self.s.init_specs))

    def f1_plain(self, i: int):
        from pixie_tpu_torch.ops import finalize as fin
        from pixie_tpu_torch.ops import gang as g1

        st = self.init(self.dev)
        g1.run_plain([self.member(i, st)], self.n(i), self.dev)
        return fin.merge_finalize_plain([st], self.rt, self.finals)

    def per_sink(self, i: int, state=None):
        cols, n_valid = self.feeds[i]
        state = self.init(self.dev) if state is None else state
        self.s.step(cols, n_valid, self.t_lo, self.t_hi, None, self.luts, state, self.s.origins)
        return state

    def k3(self, state) -> list:
        return [f.sketch.quantile_device(state[name], list(f.qs))
                for name, f in self.finals.items()]

    def feed_bytes(self, i: int) -> int:
        """The bytes of the feed columns F1 reads over feed i (each once)."""
        import torch

        m = self.member(i, self.init(self.dev))
        cols = {c.data_ptr(): c.numel() * c.element_size() for c in m.cols}
        for leaf in m.leaves:
            if isinstance(leaf.value, torch.Tensor):
                cols[leaf.value.data_ptr()] = leaf.value.numel() * leaf.value.element_size()
        return sum(cols.values())


def same_finalized(label: str, got, want) -> float:
    """Two F1 / F2 outputs leaf by leaf after their host unpack: float64 sums
    to rtol 1e-12 (atomic order), every other leaf (counts, int64 sums, min,
    max, quantiles) exactly; → the largest float64 sum difference."""
    from pixie_tpu_torch.ops import pack as p1

    err = 0.0
    for a, b in zip(got.unpack(got.buf.cpu().numpy()), want.unpack(want.buf.cpu().numpy())):
        la, lb = p1.flatten(a), p1.flatten(b)
        if [p for p, _ in la] != [p for p, _ in lb]:
            raise AssertionError(f"{label}: output trees differ")
        for (path, x), (_p, y) in zip(la, lb):
            if x.dtype.kind == "f" and path[-1] == "sum":
                ok = np.allclose(x, y, rtol=1e-12, atol=0, equal_nan=True)
                err = max(err, float(np.nan_to_num(np.abs(x - y)).max()) if x.size else 0.0)
            else:
                ok = np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
            if not ok:
                raise AssertionError(f"{label}: leaf {'/'.join(map(str, path))} differs")
    return err


def config1_states(dev, g: int, n: int, seed: int) -> list:
    """n states of config #1's tree at g groups (count, mean, p50 sketch,
    seen), counts small enough that every sketch's running count stays
    below 2^24 when 8 merge (exact in float32 in any order)."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({"cnt": torch.from_numpy(rng.integers(0, 1 << 20, g)).to(dev),
                    "avg_lat": {"sum": torch.from_numpy(rng.exponential(50.0, g) * 1e4).to(dev),
                                "count": torch.from_numpy(rng.integers(0, 1 << 20, g)).to(dev)},
                    "p50": torch.from_numpy(rng.integers(0, 1 << 10, (g, WIDTH)).astype(
                        np.float32)).to(dev),
                    "__seen": torch.from_numpy(rng.integers(0, 1 << 20, g)).to(dev)})
    return out


def check_finalize_kernels(dev, ts) -> list[dict]:
    """F1, F2 and P1 against their plain versions on the card, each timed
    (CUDA events; device time by torch.profiler) beside its plain version,
    its bound and its yardstick:
      F1 on config #1's first 16M-row feed of the 64M-row table (the small
         leaves in private shared accumulators, the sketch on global atomics)
         and on config #2's chain (1,024 groups: global atomics), beside the per-sink route on the same feed (C1, three K1,
         K2, then K3);
      F2 at N = 1 (config #1's state after the per-feed route), N = 4 (the
         four feeds' states: mesh config #1's shape) and the bandwidth shape
         (8 states of 2^16 groups, 1.08 GB), beside M1 + K3 as separate
         launches;
      P1 on config #4's state (64 groups, 133,632 B) and on a 2^20-group
         state of count, mean and seen, beside torch.cat per dtype.
    Exact for counts, int64 sums, min, max, quantiles and packed bytes;
    float64 sums to rtol 1e-12."""
    import torch

    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.ops import finalize as fin
    from pixie_tpu_torch.ops import merge as m1
    from pixie_tpu_torch.ops import pack as p1

    rows = []
    # ---- F1
    c1_feeds = AggFeeds(dev, ts, http_plan())
    n = c1_feeds.n(0)
    err = same_finalized("F1 config #1 feed", c1_feeds.f1(0), c1_feeds.f1_plain(0))
    route = c1_feeds.per_sink(0)
    err = max(err, same_finalized("F1 against the per-sink route", c1_feeds.f1(0),
                                  fin.merge_finalize_plain([route], c1_feeds.rt,
                                                           c1_feeds.finals)))
    out_bytes = fin.output_layout(c1_feeds.init("meta"), c1_feeds.finals).nbytes

    def f1_timed(feeds, i, out_b):
        """F1 over feed i: CUDA events, device time, host µs a call, bound
        and the per-sink route (C1, K1, K2, then K3) on the same feed."""
        def route():
            feeds.k3(feeds.per_sink(i))

        return {"ms": cuda_ms(lambda: feeds.f1(i), 20),
                "device_ms": kernel_device_ms(lambda: feeds.f1(i), 10),
                "host_us": host_us(lambda: feeds.f1(i)),
                "plain_ms": cuda_ms(lambda: feeds.f1_plain(i), 3, warmup=1),
                "per_sink_ms": cuda_ms(route, 20),
                "bound_ms": bound(feeds.feed_bytes(i) + out_b)[0],
                "bound_by": bound(feeds.feed_bytes(i) + out_b)[1]}

    f1 = f1_timed(c1_feeds, 0, out_bytes)
    b_ms, b_by = f1["bound_ms"], f1["bound_by"]
    log(json.dumps({"check": "F1 config #1 (16M-row feed, 64 groups)", "ok": True,
                    "max_abs_err": err, "layout": c1_feeds.f1_layout(), **f1}))
    small = c1_feeds.add_feed(0, INTERACTIVE_ROWS)
    err_1m = same_finalized("F1 config #1 at 1M rows", c1_feeds.f1(small),
                            c1_feeds.f1_plain(small))
    f1_1m = {"rows": INTERACTIVE_ROWS, "max_abs_err": err_1m,
             **f1_timed(c1_feeds, small, out_bytes)}
    log(json.dumps({"check": "F1 config #1 (1M rows, 64 groups)", "ok": True, **f1_1m}))
    nan_feed = c1_feeds.add_feed(0, nan_share=0.2)
    for nan_bin in (0, 1):
        c1_feeds.s.kern.nan_bin = nan_bin
        e = same_finalized(f"F1 20% NaN, NaN bin {nan_bin}", c1_feeds.f1(nan_feed),
                           c1_feeds.f1_plain(nan_feed))
        log(json.dumps({"check": f"F1 config #1, 20% NaN, NaN bin {nan_bin}", "ok": True,
                        "max_abs_err": e}))
    c1_feeds.s.kern.nan_bin = 1
    del c1_feeds.feeds[small:]
    c2_feeds = AggFeeds(dev, ts, config2_plan())
    err2 = same_finalized("F1 config #2 feed", c2_feeds.f1(0), c2_feeds.f1_plain(0))
    c2_out = fin.output_layout(c2_feeds.init("meta"), c2_feeds.finals).nbytes
    f1_c2 = {"groups": c2_feeds.s.num_groups, "max_abs_err": err2,
             **f1_timed(c2_feeds, 0, c2_out), "layout": c2_feeds.f1_layout()}
    log(json.dumps({"check": "F1 config #2 (16M-row feed, 1,024 groups)", "ok": True, **f1_c2}))
    rows.append({
        "name": "fused_partial_finalize F1", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/finalize.cu",
        "replaces": "pixie_tpu/engine/executor.py:1004 _fused_partial_finalize",
        "entry": F1, "path": "config1_one_feed", "max_abs_err": max(err, err_1m, err2),
        "ms": f1["ms"], "plain_ms": f1["plain_ms"], "per_sink_ms": f1["per_sink_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"rows": n, "groups": c1_feeds.s.num_groups, "output_bytes": out_bytes,
                  "device_ms": f1["device_ms"], "host_us": f1["host_us"], "1M": f1_1m,
                  "config2": f1_c2},
    })
    del c2_feeds
    # ---- F2
    cases = {}

    def hold_f2(label, states, rt, finals):
        got = fin.merge_finalize(states, rt, finals)
        err_ = same_finalized(f"F2 {label}", got, fin.merge_finalize_plain(states, rt, finals))
        nbytes = sum(x.numel() * x.element_size()
                     for st in states for _p, x in p1.flatten(st))
        b_ms_, b_by_ = bound(nbytes + got.layout.nbytes)

        def m1_k3():
            merged = m1.merge_states(rt, states, packed=False)
            for name, f in finals.items():
                f.sketch.quantile_device(merged[name], list(f.qs))

        reps = 20 if nbytes < (1 << 26) else 10
        cases[label] = {
            "states": len(states), "state_bytes": nbytes // len(states), "max_abs_err": err_,
            "ms": cuda_ms(lambda: fin.merge_finalize(states, rt, finals), reps),
            "device_ms": kernel_device_ms(lambda: fin.merge_finalize(states, rt, finals), reps),
            "host_us": host_us(lambda: fin.merge_finalize(states, rt, finals)),
            "plain_ms": cuda_ms(lambda: fin.merge_finalize_plain(states, rt, finals), 3),
            "m1_k3_ms": cuda_ms(m1_k3, reps), "bound_ms": b_ms_, "bound_by": b_by_}
        log(json.dumps({"check": f"F2 {label}", "ok": True, **cases[label]}))

    feed_states = [c1_feeds.per_sink(i) for i in range(len(c1_feeds.feeds))]
    hold_f2("N = 1 (config #1's state)", feed_states[:1], c1_feeds.rt, c1_feeds.finals)
    hold_f2(f"N = {len(feed_states)} (config #1's feeds' states)", feed_states, c1_feeds.rt,
            c1_feeds.finals)
    wide = config1_states(dev, F2_WIDE_GROUPS, F2_WIDE_STATES, 41)
    hold_f2(f"bandwidth shape ({F2_WIDE_STATES} x 2^16 groups)", wide, c1_feeds.rt,
            c1_feeds.finals)
    del wide, feed_states
    torch.cuda.empty_cache()
    main = cases["N = 1 (config #1's state)"]
    rows.append({
        "name": "merge_finalize F2", "route": "cuda", "source": "pixie_tpu_torch/csrc/finalize.cu",
        "replaces": "pixie_tpu/engine/executor.py:982 _merge_finalize_fn "
                    "(:967 _device_finalize_split)",
        "entry": F2, "path": "config1", "max_abs_err": max(c["max_abs_err"] for c in
                                                              cases.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "m1_k3_ms": main["m1_k3_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "shape": {**cases, "host_us": main["host_us"]},
    })
    # ---- P1
    packs = {}
    for label, st in (("config #4's state (64 groups)", config1_states(dev, 64, 1, 42)[0]),
                      ("2^20 groups of count, mean and seen",
                       {k: v for k, v in config1_states(dev, P1_WIDE_GROUPS, 1, 43)[0].items()
                        if k != "p50"})):
        layout = p1.state_packer(st)
        leaves = [x for _p, x in p1.flatten(st)]
        got, want = p1.pack(leaves, layout), p1.pack_plain(leaves, layout)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"P1 {label}: kernel and plain version disagree")
        pulled = layout.unpack(got.cpu().numpy())
        for (path, x), (_p, y) in zip(p1.flatten(pulled), p1.flatten(st)):
            if not np.array_equal(x, y.cpu().numpy()):
                raise AssertionError(f"P1 {label}: leaf {path} unpacks differently")
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        dtypes = sorted({x.dtype for x in leaves}, key=str)

        def library(leaves=leaves, dtypes=dtypes):
            return [torch.cat([x.reshape(-1) for x in leaves if x.dtype == d]) for d in dtypes]

        b_ms_, b_by_ = bound(2 * nbytes)
        packs[label] = {
            "state_bytes": nbytes, "leaves": len(leaves), "dtypes": len(dtypes),
            "ms": cuda_ms(lambda: p1.pack(leaves, layout), 20),
            "device_ms": kernel_device_ms(lambda: p1.pack(leaves, layout), 20),
            "host_us": host_us(lambda: p1.pack(leaves, layout)),
            "plain_ms": cuda_ms(lambda: p1.pack_plain(leaves, layout), 10),
            "library_ms": cuda_ms(library, 20), "library_host_us": host_us(library),
            "bound_ms": b_ms_, "bound_by": b_by_}
        log(json.dumps({"check": f"P1 {label}", "ok": True, "max_abs_err": 0.0,
                        **packs[label]}))
    # past one launch's table: two launches, the buffer byte for byte
    rng = np.random.default_rng(44)
    dts = (np.int32, np.int64, np.float32, np.float64)
    leaves = [torch.from_numpy(rng.integers(-1000, 1000, 1 + (i * 37) % 300).astype(
        dts[i % 4])).to(dev) for i in range(P1_PAST_LEAVES)]
    layout = p1.Layout.of([((f"l{i}",), x.dtype, x.shape) for i, x in enumerate(leaves)])
    before = _build.KERNELS["pack"].launches
    got = p1.pack(leaves, layout)
    torch.cuda.synchronize()
    past_launches = _build.KERNELS["pack"].launches - before
    if past_launches != len(layout.p1.launches) or past_launches < 2 or \
            not torch.equal(got, p1.pack_plain(leaves, layout)):
        raise AssertionError(f"P1 past one launch's capacity: {past_launches} launches, "
                             "or the buffer differs from the plain version's")
    packs["past capacity"] = {"leaves": P1_PAST_LEAVES, "launches": past_launches,
                              "host_us": host_us(lambda: p1.pack(leaves, layout))}
    log(json.dumps({"check": "P1 past one launch's capacity", "ok": True, "max_abs_err": 0.0,
                    **packs["past capacity"]}))
    main = packs["config #4's state (64 groups)"]
    rows.append({
        "name": "state_pack P1", "route": "cuda", "source": "pixie_tpu_torch/csrc/pack.cu",
        "replaces": "pixie_tpu/engine/executor.py:912 _state_packer",
        "entry": P1, "path": "batch", "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": {**packs, "host_us": main["host_us"], "device_ms": main["device_ms"]},
    })
    return rows


def run_config1_one_feed(dev) -> dict:
    """Config #1 at one feed: bench's build_http_table (config #1's widths)
    at 16M rows and at the 1M-row interactive shape.  Each query is one F1
    launch: the oracle holds, a warm query launches F1 once and C1, K1, K2
    and K3 not at all, and reads back in one D2H wave; stream and warm
    medians.  Then the same query on the 16M rows with PX_FEED_ROWS = 2^23:
    two feeds on the per-feed route and F2 once, equal to F1's result.
    Last, each size in a fresh process: a warm query's CUDA-only profile
    holds no host-to-device copy (one_feed_h2d_probe)."""
    import torch

    from pixie_tpu_torch import flags
    from pixie_tpu_torch.engine import execute_plan, transfer
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore

    plan = http_plan()
    out = {}
    for label, rows in (("16M", ONE_FEED_ROWS), ("1M", INTERACTIVE_ROWS)):
        t0 = time.perf_counter()
        ts = TableStore()
        table, _gen = build_http_table(ts, rows)
        data_s = time.perf_counter() - t0

        def query(ts=ts):
            r = execute_plan(plan, ts, device=dev)["output"]
            torch.cuda.synchronize(dev)
            return r

        _build.reset_launches()
        res = query()
        cold = read_launches(f"config #1 at one feed ({label})", [F1])
        check = oracle_check(table, res)
        _build.reset_launches()
        waves0 = transfer.stats["waves"]
        warm = query()
        waves = transfer.stats["waves"] - waves0
        warm_all = {lib: dict(k.by_entry) for lib, k in _build.KERNELS.items()}
        launches = {lib: e for lib, e in warm_all.items() if e}
        if (launches != {"finalize": {F1[1]: 1}} or waves != 1
                or warm.exec_stats.get("fused_single_feed") != 1):
            raise AssertionError(f"config #1 at one feed ({label}): launches {launches}, "
                                 f"{waves} D2H waves, stats {warm.exec_stats}")
        same_frame(f"config #1 at one feed ({label}) warm", warm, res, ["service", "status"],
                   exact=("cnt", "p50"))
        routes = stream_and_warm(query, f"config #1 at one feed ({label})", with_profile=True)
        for k in ("profile_stream", "profile_warm"):
            routes[k]["top"] = routes[k]["top"][:6]
        # every device event of a warm query (kernel and copies), as the F1
        # check times its kernel: the profile above may hold none of them
        busy = device_busy_ms(query, 5)
        out[label] = {"rows": rows, "data_s": data_s, **check, "cold_launches": cold,
                      "warm_launches": launches, "warm_d2h_waves": waves, **routes,
                      "warm_device_busy_ms": busy,
                      "warm_device_idle_share": 1.0 - busy / (routes["warm_median_s"] * 1e3),
                      "rows_per_s": rows / routes["warm_median_s"]}
        if label == "16M":
            out["launches"] = warm_all  # one warm query's
            saved = flags.get("PX_FEED_ROWS")
            flags.set_for_testing("PX_FEED_ROWS", ONE_FEED_ROWS // 2)
            try:
                _build.reset_launches()
                two = query()
                two_launches = {lib: dict(k.by_entry) for lib, k in _build.KERNELS.items()
                                if k.launches}
                if (two_launches.get("finalize") != {F2[1]: 1}
                        or two_launches.get("chain", {}).get(C1[1]) != 2
                        or "loghist_quantile" in two_launches):
                    raise AssertionError(f"config #1 in two feeds: launches {two_launches}")
                same_frame("config #1 in two feeds", two, res, ["service", "status"],
                           exact=("cnt", "p50"))
                two_times = warm_times(query, 2, 5)
            finally:
                flags.set_for_testing("PX_FEED_ROWS", saved)
            out["two_feeds"] = {"launches": two_launches, "warm_median_s": two_times[2],
                                "warm_s": two_times}
        log(json.dumps({"phase": f"config1_one_feed.{label}", "ok": True,
                        **{k: v for k, v in out[label].items()}}))
        del ts, table, _gen
    log(json.dumps({"phase": "config1_one_feed.two_feeds", "ok": True, **out["two_feeds"]}))
    # each size in a fresh process: in this one, after its earlier profiles,
    # a profile of the one-feed query held no device event at all
    out["warm_profile_copies"] = {}
    for label, rows in (("16M", ONE_FEED_ROWS), ("1M", INTERACTIVE_ROWS)):
        probe = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                                f"chip_smoke.one_feed_h2d_probe({rows})"],
                               capture_output=True, text=True, timeout=300)
        if probe.returncode != 0:
            raise AssertionError(f"the one-feed copy probe failed: {probe.stderr[-2000:]}")
        copies = json.loads(probe.stdout.strip().splitlines()[-1])
        out["warm_profile_copies"][label] = copies
        log(json.dumps({"phase": f"config1_one_feed.{label}.warm_profile", **copies}))
        if copies["h2d_per_call"] or not copies["device_events_per_call"]:
            raise AssertionError(f"config #1 at one feed ({label}): a warm query's CUDA-only "
                                 f"profile: {copies}")
    return out


def one_feed_h2d_probe(rows: int) -> None:
    """Config #1 at one feed over bench's build_http_table at `rows` rows,
    warm, under a CUDA-only profile in this process: prints its
    h2d_copies as JSON."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.table import TableStore

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    plan = http_plan()
    ts = TableStore()
    build_http_table(ts, rows)

    def query():
        execute_plan(plan, ts, device=dev)
        torch.cuda.synchronize(dev)

    query()
    print(json.dumps(h2d_copies(query)), flush=True)


def check_dicthist_library(dev) -> dict:
    """Row 18's yardstick: K1's count over gid * 256 + code (DictHistUDA's
    update) beside its plain version and torch.bincount of the same flat
    ids, one call each, at the ml phase's shape (8M rows into 16 x 256
    cells)."""
    import torch

    from pixie_tpu_torch.ops import groupby as gb

    rng = np.random.default_rng(44)
    n, g, cap = 1 << 23, N_SERVICES, 256
    gid = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).to(dev)
    code = torch.from_numpy(rng.integers(0, cap, n).astype(np.int32)).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    flat = gid * cap + code
    got = gb.masked_segment_count(flat, g * cap, mask)
    want = torch.bincount(flat, minlength=g * cap)

    def plain():
        return gb.segment_count_plain(flat, g * cap, mask,
                                      torch.zeros(g * cap, dtype=torch.int64, device=dev))

    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(plain(), want):
        raise AssertionError("DictHist count: K1, its plain version and torch.bincount "
                             "disagree")
    out = {"rows": n, "cells": g * cap,
           "k1_ms": cuda_ms(lambda: gb.masked_segment_count(flat, g * cap, mask), 20),
           "plain_ms": cuda_ms(plain, 5),
           "library_ms": cuda_ms(lambda: torch.bincount(flat, minlength=g * cap), 20),
           "bound_ms": bound(n * (4 + 1) + g * cap * 8)[0]}
    log(json.dumps({"check": "row 18 DictHist count (K1) vs torch.bincount", "ok": True, **out}))
    return out


def batch_frame(res, keys) -> dict:
    """A result's columns (service decoded to its index) sorted by its keys."""
    cols = {}
    for name in res.relation.names():
        if name == "service":
            cols[name] = np.array([int(v.split("-")[1]) for v in res.decoded(name)],
                                  dtype=np.int64)
        else:
            cols[name] = np.asarray(res.columns[name])
    order = np.lexsort([cols[k] for k in reversed(keys)])
    return {k: v[order] for k, v in cols.items()}


def batch_same(label: str, got: dict, want: dict) -> None:
    """Counts, keys, min, max and quantiles exactly; means to rtol 1e-12."""
    if sorted(got) != sorted(want) or len(next(iter(got.values()))) != len(
            next(iter(want.values()))):
        raise AssertionError(f"{label}: columns or groups differ")
    for k in got:
        if k in ("avg_lat", "avg"):
            ok = np.allclose(got[k], want[k], rtol=1e-12, atol=0)
        else:
            ok = np.array_equal(got[k], want[k])
        if not ok:
            raise AssertionError(f"{label}: column {k} differs")


def batch_oracle(table, frames: list) -> dict:
    """Each script's solo result (a batch_frame) against a numpy oracle over
    the table: counts exact, means to rtol 1e-9, max and min exact, p50 and
    p99 in the oracle's sketch bin or the next."""
    cols = _table_columns(table, ("service", "latency", "status"))
    names = table.dictionaries["service"].decode(np.arange(table.dictionaries["service"].size))
    idx = np.array([int(v.split("-")[1]) for v in names], dtype=np.int64)
    svc, lat, st = idx[cols["service"]], cols["latency"], cols["status"]
    statuses = np.unique(st)
    out = {}

    def counts(label, f, sel, key, ng):
        cnt = np.bincount(key[sel], minlength=ng)
        if not np.array_equal(f["cnt"], cnt[cnt > 0]):
            raise AssertionError(f"{label}: counts differ from the oracle")
        return cnt

    # 0: status != 404, by (service, status): count, mean
    sel = st != 404
    key = svc * len(statuses) + np.searchsorted(statuses, st)
    ng = N_SERVICES * len(statuses)
    cnt = counts("batch script 0", frames[0], sel, key, ng)
    mean = np.bincount(key[sel], weights=lat[sel], minlength=ng) / np.maximum(cnt, 1)
    if not np.allclose(frames[0]["avg_lat"], mean[cnt > 0], rtol=1e-9, atol=0):
        raise AssertionError("batch script 0: means differ from the oracle")
    # 1: latency > 10, by service: count, max
    sel = lat > 10.0
    cnt = counts("batch script 1", frames[1], sel, svc, N_SERVICES)
    mx = np.full(N_SERVICES, -np.inf)
    np.maximum.at(mx, svc[sel], lat[sel])
    if not np.array_equal(frames[1]["mx"], mx[cnt > 0]):
        raise AssertionError("batch script 1: max differs from the oracle")
    # 2: by status: p50, p99
    key2 = np.searchsorted(statuses, st)
    orc = SketchOracle(len(statuses))
    orc.add(key2, lat)
    out["p_exact_bins"] = {q: check_bins(f"batch script 2 {q}", frames[2][q],
                                         orc.quantile(v)) for q, v in (("p50", 0.5),
                                                                        ("p99", 0.99))}
    # 3: status == 200, by service: mean, min
    sel = st == 200
    cnt = np.bincount(svc[sel], minlength=N_SERVICES)
    mean = np.bincount(svc[sel], weights=lat[sel], minlength=N_SERVICES) / np.maximum(cnt, 1)
    mn = np.full(N_SERVICES, np.inf)
    np.minimum.at(mn, svc[sel], lat[sel])
    if not (np.allclose(frames[3]["avg"], mean[cnt > 0], rtol=1e-9, atol=0)
            and np.array_equal(frames[3]["mn"], mn[cnt > 0])):
        raise AssertionError("batch script 3: mean or min differs from the oracle")
    out["groups"] = [len(f[k[0]]) for f, k in zip(frames, BATCH_KEYS)]
    return out


def run_batch(dev, ts, table) -> dict:
    """The four BATCH_SCRIPTS through LocalCluster.query over the 64M-row
    table from 16 client threads (4 per script, BATCH_QUERIES queries each),
    unbatched (PL_QUERY_BATCHING=0, PX_MQ_FUSION=0) and then batched (both
    on: the gang on G1); every result equal to the script's solo result,
    which equals a numpy oracle."""
    import threading

    import torch

    from pixie_tpu_torch import flags, metrics
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.serving import batching

    cl = LocalCluster({"pem0": ts}, device=dev)

    def query(i):
        t0 = time.perf_counter()
        r = cl.query(BATCH_SCRIPTS[i])["out"]
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, r

    def clients(nq):
        """16 threads, started together; → (wall, [(script, seconds, result)])."""
        out, errs = [], []
        lock = threading.Lock()
        n_thr = len(BATCH_SCRIPTS) * BATCH_CLIENTS_PER_SCRIPT
        barrier = threading.Barrier(n_thr + 1, timeout=300)

        def run(i):
            try:
                barrier.wait()
                for _ in range(nq):
                    s, r = query(i)
                    with lock:
                        out.append((i, s, r))
            except Exception as e:  # raised below, after every thread ends
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i % len(BATCH_SCRIPTS),))
                   for i in range(n_thr)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errs:
            raise AssertionError(f"batch clients failed: {errs[:3]}")
        return wall, out

    saved = {f: flags.get(f) for f in ("PL_QUERY_BATCHING", "PX_MQ_FUSION")}
    try:
        flags.set_for_testing("PL_QUERY_BATCHING", False)
        flags.set_for_testing("PX_MQ_FUSION", 0)
        solo = [batch_frame(query(i)[1], BATCH_KEYS[i]) for i in range(len(BATCH_SCRIPTS))]
        check = batch_oracle(table, solo)
        log(json.dumps({"phase": "batch.oracle", "ok": True, **check}))
        arms, launches = {}, None
        for arm, on in (("unbatched", False), ("batched", True)):
            flags.set_for_testing("PL_QUERY_BATCHING", on)
            flags.set_for_testing("PX_MQ_FUSION", -1 if on else 0)
            clients(1)  # warm: the gang's union column set has its own tier entry
            batching.reset_for_testing()
            formed0 = metrics.counter_value("px_batch_formed_total")
            g0 = _build.KERNELS["gang"].launches
            if on:
                _build.reset_launches()
            wall, out = clients(BATCH_QUERIES)
            if on:
                launches = read_launches("batch", BATCH_KERNELS)
            g1_launches = _build.KERNELS["gang"].launches - (0 if on else g0)
            formed = metrics.counter_value("px_batch_formed_total") - formed0
            for i, _s, r in out:
                batch_same(f"batch {arm} script {i}", batch_frame(r, BATCH_KEYS[i]), solo[i])
            execs = {id(r.exec_stats["agents"]): r.exec_stats["agents"]["pem0"]
                     for _i, _s, r in out}
            lat = sorted(s for _i, s, _r in out)
            arms[arm] = {
                "queries": len(out), "wall_s": wall, "goodput_qps": len(out) / wall,
                "p50_latency_s": lat[len(lat) // 2], "p99_latency_s": lat[-1 - len(lat) // 100],
                "recent_size_p50": batching.recent_size_p50(), "batches_formed": formed,
                "batched_queries": sum(1 for _i, _s, r in out if "batch" in r.exec_stats),
                "executions": len(execs),
                "mq_fused": sum(e.get("mq_fused", 0) for e in execs.values()),
                "mq_waves": sum(e.get("mq_waves", 0) for e in execs.values()),
                "g1_launches": g1_launches,
                "g1_launches_per_batch": g1_launches / formed if formed else 0.0,
                "h2d_bytes": sum(e.get("h2d_bytes", 0) for e in execs.values())}
            log(json.dumps({"phase": f"batch.{arm}", **arms[arm]}))
        b = arms["batched"]
        if not (b["batches_formed"] > 0 and b["g1_launches"] > 0 and b["mq_fused"] > 0):
            raise AssertionError(f"batch: no batch formed or G1 never launched: {b}")
        # a warm batch: the four scripts from four threads, one batch, whose
        # CUDA-only profile holds no host-to-device copy
        saved_max = flags.get("PL_BATCH_MAX_QUERIES")
        flags.set_for_testing("PL_BATCH_MAX_QUERIES", len(BATCH_SCRIPTS))

        def one_batch():
            threads = [threading.Thread(target=query, args=(i,))
                       for i in range(len(BATCH_SCRIPTS))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)

        try:
            formed0 = metrics.counter_value("px_batch_formed_total")
            copies = h2d_copies(one_batch)
            copies["batches_formed"] = metrics.counter_value("px_batch_formed_total") - formed0
        finally:
            flags.set_for_testing("PL_BATCH_MAX_QUERIES", saved_max)
        log(json.dumps({"phase": "batch.warm_profile", **copies}))
        if copies["h2d_per_call"] or not copies["batches_formed"]:
            raise AssertionError(f"batch: a warm batch's CUDA-only profile: {copies}")
        arms["warm_batch_profile"] = copies
        if arms["unbatched"]["batches_formed"] or arms["unbatched"]["g1_launches"]:
            raise AssertionError("batch: the unbatched arm batched or launched G1")
    finally:
        for f, v in saved.items():
            flags.set_for_testing(f, v)
    return {"launches": launches, "arms": arms, "oracle": check,
            "device_memory": device_memory()}

# ------------------------------------------------- the mesh path (slice 8)

#: co-located shards of the mesh phases (PIXIE_TORCH_VIRTUAL_SHARDS)
MESH_SHARDS = 4
#: X1 / X2 check rows (one int64 and one dictionary key; values f64, int64)
X_ROWS = 1 << 24
X_DICT = 4096
#: config #1 over the mesh: every kernel of the path; F2 merges the shards'
#: states (N = 4) as it finalizes, so M1 does not launch
MESH_CONFIG1_KERNELS = CONFIG1_KERNELS
X_KERNELS = [("repartition", "px_partition_count"), ("repartition", "px_partition_scatter")]
#: the mesh cluster: agents, config #4's rows over them, the join's rows a side
MESH_AGENTS = 2
MESH_JOIN_ROWS = 1 << 21
MESH_JOIN_KEYS = 1 << 20
#: bench config #4's script with a repartitioned join of two tables spread
#: over the agents, keyed on an int64 and a string column
MESH_JOIN_SCRIPT = """
left = px.DataFrame(table='left_t')
right = px.DataFrame(table='right_t')
df = left.merge(right, how='inner', left_on=['k', 's'], right_on=['k', 's'],
                suffixes=['', '_r'])
px.display(df, 'out')
"""


class virtual_shards:
    """PIXIE_TORCH_VIRTUAL_SHARDS set for the mesh phases, restored after."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        from pixie_tpu_torch import flags
        import pixie_tpu_torch.parallel  # noqa: F401  (defines the flag)

        self.saved = flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")
        flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", self.n)

    def __exit__(self, *exc):
        from pixie_tpu_torch import flags

        flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", self.saved)


def x_inputs(dev, n_dev: int, skew: bool, rng):
    """X_ROWS rows over n_dev shards: an int64 key k (full range), a
    dictionary key s (X_DICT values, 1% null), values v (f64) and w (int64);
    with skew, one k value holds half the rows."""
    import torch

    from pixie_tpu_torch.ops import repartition as xr

    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, X_ROWS, dtype=np.int64)
    if skew:
        k[rng.random(X_ROWS) < 0.5] = 42
    s = rng.integers(0, X_DICT, X_ROWS).astype(np.int32)
    s[rng.random(X_ROWS) < 0.01] = -1
    cols = [torch.from_numpy(a).to(dev) for a in
            (k, s, rng.exponential(50.0, X_ROWS), rng.integers(0, 1 << 40, X_ROWS))]
    lut = torch.from_numpy(xr.value_hash_lut([f"v{i}" for i in range(X_DICT)])).to(dev)
    nv = np.full(n_dev, X_ROWS // n_dev, dtype=np.int64)
    return [(cols[0], None), (cols[1], lut)], cols, nv


#: the mesh exchange's shape: one agent's left_t (time_exchange)
X_PHASE_ROWS = 1 << 21
X_PHASE_LABEL = "the mesh exchange's shape, 4 partitions"


def x_phase_inputs(dev):
    """One agent's left_t as the mesh exchange sends it: X_PHASE_ROWS rows
    of time_ (int64), k (int64 in [0, MESH_JOIN_KEYS)), s (int32 codes of
    N_SERVICES services) and lv (int64), keyed on (k, s), over MESH_SHARDS
    shards."""
    import torch

    from pixie_tpu_torch.ops import repartition as xr

    rng = np.random.default_rng(20)
    n = X_PHASE_ROWS
    cols = [torch.from_numpy(a).to(dev) for a in (
        np.arange(n, dtype=np.int64), rng.integers(0, MESH_JOIN_KEYS, n).astype(np.int64),
        rng.integers(0, N_SERVICES, n).astype(np.int32), rng.integers(0, 1 << 40, n))]
    lut = torch.from_numpy(xr.value_hash_lut([f"svc-{i}" for i in range(N_SERVICES)])).to(dev)
    return ([(cols[1], None), (cols[2], lut)], cols,
            np.full(MESH_SHARDS, n // MESH_SHARDS, dtype=np.int64))


def check_repartition_kernels(dev) -> list[dict]:
    """X1 and X2 held against their plain versions at X_ROWS rows over 4
    and 8 partitions, over 4 with one key holding half the rows, and at the
    mesh exchange's own shape (x_phase_inputs): part,
    the counts and the tile counts exactly; the received counts exactly and
    every block's received rows bit for bit.  Timed (CUDA events; X2 also
    device time and host microseconds a call) beside the plain versions and
    the bound; no single PyTorch call partitions stably,
    so the library column is null.  Rows: X1, X2 at 4 partitions."""
    import torch

    from pixie_tpu_torch.ops import repartition as xr

    rng = np.random.default_rng(19)
    out = {}
    for label, n_dev, skew in (("4 partitions", 4, False), ("8 partitions", 8, False),
                               ("4 partitions, one key half the rows", 4, True),
                               (X_PHASE_LABEL, MESH_SHARDS, False)):
        if label == X_PHASE_LABEL:
            keys, cols, nv = x_phase_inputs(dev)
        else:
            keys, cols, nv = x_inputs(dev, n_dev, skew, rng)
        n = cols[0].shape[0]
        part, counts, tiles = xr.partition_count(keys, nv, n_dev)
        wpart, wcounts, wtiles = xr.partition_count_plain(keys, nv, n_dev)
        torch.cuda.synchronize()
        if not (torch.equal(part, wpart) and torch.equal(counts, wcounts)
                and torch.equal(tiles, wtiles)):
            raise AssertionError(f"X1 {label}: kernel and plain version disagree")
        cap = int(counts.max())
        outs, recv = xr.partition_scatter(part, tiles, counts, cols, n_dev, cap)
        wouts, wrecv = xr.partition_scatter_plain(part, tiles, counts, cols, n_dev, cap)
        torch.cuda.synchronize()
        if not torch.equal(recv, wrecv) or int(recv.sum()) != n:
            raise AssertionError(f"X2 {label}: received counts differ or lost rows")
        valid = torch.arange(cap, device=dev).view(1, cap) < recv.view(-1, 1)
        for g, w in zip(outs, wouts):
            if not torch.equal(g.view(-1, cap)[valid], w.view(-1, cap)[valid]):
                raise AssertionError(f"X2 {label}: kernel and plain version disagree")
        del wouts
        x1_bytes = n * (8 + 4 + 4)
        x2_bytes = n * (4 + 2 * sum(c.element_size() for c in cols))
        b1, by1 = bound(x1_bytes)
        b2, by2 = bound(x2_bytes)

        def x2():
            return xr.partition_scatter(part, tiles, counts, cols, n_dev, cap)

        out[label] = {
            "rows": n, "partitions": n_dev, "cap": cap, "skew": skew,
            "x1_ms": cuda_ms(lambda: xr.partition_count(keys, nv, n_dev), 20),
            "x1_plain_ms": cuda_ms(lambda: xr.partition_count_plain(keys, nv, n_dev), 3),
            "x1_bound_ms": b1, "x1_bound_by": by1,
            "x2_ms": cuda_ms(x2, 10), "x2_device_ms": kernel_device_ms(x2, 10),
            "x2_host_us": host_us(x2, 50),
            "x2_plain_ms": cuda_ms(lambda: xr.partition_scatter_plain(
                part, tiles, counts, cols, n_dev, cap), 3),
            "x2_bound_ms": b2, "x2_bound_by": by2}
        log(json.dumps({"check": f"X1 X2 {label}", "ok": True, "max_abs_err": 0.0,
                        **out[label]}))
        del outs, cols, keys
        torch.cuda.empty_cache()
    main = out["4 partitions"]
    shape = {"rows": X_ROWS, "columns": "k int64, s int32 codes, v f64, w int64",
             "phase_columns": "time_ int64, k int64, s int32 codes, lv int64", "cases": out}
    return [{
        "name": "partition_count", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/repartition.cu",
        "replaces": "pixie_tpu/parallel/repartition.py:156 _device_key_fn "
                    "(:358 mesh_bucket_counts)",
        "entry": ("repartition", "px_partition_count"), "path": "mesh_cluster",
        "max_abs_err": 0.0, "ms": main["x1_ms"], "plain_ms": main["x1_plain_ms"],
        "bound_ms": main["x1_bound_ms"], "bound_by": main["x1_bound_by"],
        "library_ms": None, "shape": shape,
    }, {
        "name": "partition_scatter", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/repartition.cu",
        "replaces": "pixie_tpu/parallel/repartition.py:335 _local_partition "
                    "(:395 mesh_repartition, its all_to_all)",
        "entry": ("repartition", "px_partition_scatter"), "path": "mesh_cluster",
        "max_abs_err": 0.0, "ms": main["x2_ms"], "plain_ms": main["x2_plain_ms"],
        "bound_ms": main["x2_bound_ms"], "bound_by": main["x2_bound_by"],
        "library_ms": None, "shape": {"rows": X_ROWS, "partitions": 4},
    }]


def check_collective_merge(dev) -> list[dict]:
    """M1 as the collective merge (row 13) of MESH_SHARDS shard states of
    config #1's state (64 groups: count, mean, p50 sketch, seen), against
    its plain version, exactly; timed (CUDA events, device time, host
    microseconds a call) beside torch.stack + sum per leaf; then past one
    launch's parameter block (m1_past_capacity)."""
    import torch

    from pixie_tpu_torch.ops import merge as m1
    from pixie_tpu_torch.udf.udf import tree_map

    rng = np.random.default_rng(16)
    g = 64
    rt = {"cnt": "add", "avg_lat": {"sum": "add", "count": "add"}, "p50": "add",
          "__seen": "add"}
    sts = [tree_map(lambda a: torch.from_numpy(a).to(dev), {
        "cnt": rng.integers(0, 1 << 20, g),
        "avg_lat": {"sum": rng.exponential(50.0, g) * 1e4, "count": rng.integers(0, 1 << 20, g)},
        "p50": rng.integers(0, 1 << 12, (g, WIDTH)).astype(np.float32),
        "__seen": rng.integers(0, 1 << 20, g)}) for _ in range(MESH_SHARDS)]

    def leaves(t):
        return [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    got = state_tree(m1.collective_merge(rt, sts))
    want = m1.merge_states_plain(rt, sts)
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(leaves(got), leaves(want))):
        raise AssertionError("M1 collective merge: kernel and plain version disagree")
    nbytes = sum(x.numel() * x.element_size() for x in leaves(sts[0]))
    b_ms, by = bound((MESH_SHARDS + 1) * nbytes)

    def library():
        for xs in zip(*[leaves(x) for x in sts]):
            torch.stack(xs).sum(0)

    row = {"ms": cuda_ms(lambda: m1.collective_merge(rt, sts), 20),
           "device_ms": kernel_device_ms(lambda: m1.collective_merge(rt, sts), 20),
           "host_us": host_us(lambda: m1.collective_merge(rt, sts)),
           "plain_ms": cuda_ms(lambda: m1.merge_states_plain(rt, sts), 10),
           "library_ms": cuda_ms(library, 10), "library_host_us": host_us(library),
           "bound_ms": b_ms, "bound_by": by}
    log(json.dumps({"check": "M1 collective merge (4 shards x 64 groups)", "ok": True,
                    "max_abs_err": 0.0, **row}))
    past = m1_past_capacity(dev, m1.collective_merge, "collective merge past one launch's "
                            "capacity")
    return [{
        "name": "collective_merge", "route": "cuda", "source": "pixie_tpu_torch/csrc/merge.cu",
        "replaces": "pixie_tpu/parallel/spmd.py:174 collective_merge (psum / pmin / pmax; "
                    ":182 _carry, :203 spmd_agg_step, :234 spmd_partial_step, "
                    ":268 spmd_multi_partial_step)",
        "entry": ("merge", "px_merge_states"), "path": "mesh_cluster", "max_abs_err": 0.0,
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": b_ms, "bound_by": by,
        "library_ms": row["library_ms"],
        "shape": {"shards": MESH_SHARDS, "groups": g, "state_bytes": nbytes,
                  "device_ms": row["device_ms"], "host_us": row["host_us"],
                  "library_host_us": row["library_host_us"], "past_capacity": past},
    }]


def run_mesh_config1(dev, ts, table) -> dict:
    """Config #1 over the 64M-row table through execute_plan with a mesh of
    MESH_SHARDS co-located shards: each feed splits into 4 row blocks, each
    shard runs C1, K1 and K2 into its own state, and F2 merges the shards'
    states, finalizes and packs in one launch (no M1, no K3).  Equal to the
    single-device executor (counts and p50
    exactly, means to 1e-12) and to the numpy oracle; spmd_feeds 4 a query;
    stream and warm medians (a warm query moves 0 H2D bytes: the sharded
    resident entry and the mesh's cache entries)."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel.spmd import make_mesh

    plan = http_plan()
    with virtual_shards(MESH_SHARDS):
        mesh = make_mesh(MESH_SHARDS, device=dev)

        def query():
            r = execute_plan(plan, ts, device=dev, mesh=mesh)["output"]
            torch.cuda.synchronize(dev)
            return r

        _build.reset_launches()
        res = query()
        launches = read_launches("mesh config #1", MESH_CONFIG1_KERNELS)
        m1 = launches["merge"].get("px_merge_states", 0)
        f2 = launches["finalize"].get(F2[1], 0)
        if res.exec_stats.get("spmd_feeds") != ROWS // FEED or m1 != 0 or f2 != 1:
            raise AssertionError(f"mesh config #1: spmd_feeds {res.exec_stats.get('spmd_feeds')}"
                                 f" (want {ROWS // FEED}), M1 launches {m1} (want 0), F2 "
                                 f"launches {f2} (want 1)")
        check_leaves("mesh_config1", res.exec_stats)
        check = oracle_check(table, res)
        single = execute_plan(plan, ts, device=dev, mesh=None)["output"]
        same_frame("mesh config #1", res, single, ["service", "status"], exact=("cnt", "p50"))
        log(json.dumps({"phase": "mesh_config1.oracle", "ok": True, **check,
                        "shard_rows": res.exec_stats["shard_rows"],
                        "shard_skew_frac": res.exec_stats["shard_skew_frac"]}))
        routes = stream_and_warm(query, "mesh config #1", with_profile=True)
    for k in ("profile_stream", "profile_warm"):
        routes[k] = {kk: v for kk, v in routes[k].items() if kk != "top"} | {
            "top": routes[k]["top"][:8]}
    out = {"launches": launches, "shards": MESH_SHARDS, "spmd_feeds": ROWS // FEED,
           **routes, "rows_per_s": ROWS / routes["warm_median_s"],
           "stream_rows_per_s": ROWS / routes["stream_median_s"],
           "device_memory": device_memory()}
    log(json.dumps({"phase": "slice.mesh_config1", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


def same_frame(label: str, got, want, keys, exact=()) -> None:
    """Two results equal as frames sorted by `keys`: float columns to rtol
    1e-12 (the `exact` ones bit for bit), the rest exactly."""
    g = got.to_pandas().sort_values(keys).reset_index(drop=True)
    w = want.to_pandas().sort_values(keys).reset_index(drop=True)
    if list(g.columns) != list(w.columns) or len(g) != len(w):
        raise AssertionError(f"{label}: columns or rows differ: {len(g)} vs {len(w)}")
    for c in g.columns:
        a, b = g[c].to_numpy(), w[c].to_numpy()
        if a.dtype.kind == "f" and c not in exact:
            ok = np.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
        else:
            ok = a.tolist() == b.tolist()
        if not ok:
            raise AssertionError(f"{label}: column {c} differs")


def same_rows(label: str, got, want) -> None:
    """Two integer-and-string results equal as sorted frames: the same
    columns and the same multiset of rows (each sorted by every column).  On
    a mismatch it logs the rows each holds that the other lacks, then
    raises."""
    def rows_of(res):
        df = res.to_pandas()
        cols = [df[c].astype(str).to_numpy() for c in df.columns]
        return list(df.columns), sorted(zip(*cols))

    gc, g = rows_of(got)
    wc, w = rows_of(want)
    if gc == wc and g == w:
        return
    only_g = sorted(set(g) - set(w))
    only_w = sorted(set(w) - set(g))
    log(json.dumps({"check": f"{label} rows", "ok": False, "columns": [gc, wc],
                    "rows": [len(g), len(w)], "only_got": len(only_g), "only_want": len(only_w),
                    "examples_got": only_g[:5], "examples_want": only_w[:5]}))
    raise AssertionError(f"{label}: rows differ ({len(only_g)} only in the result, "
                         f"{len(only_w)} only in the reference)")


def _join_tables(stores: dict, rows: int, seed: int):
    """left_t and right_t of `rows` rows each, spread evenly over the agent
    stores and one store of all the rows (the single-device reference): k
    uniform in [0, MESH_JOIN_KEYS), s one of 16 services; lv, rv int64."""
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(seed)
    whole = TableStore()
    services = np.array([f"svc-{i}" for i in range(N_SERVICES)])
    names = list(stores)
    for side, val in (("left_t", "lv"), ("right_t", "rv")):
        rel = Relation.of(("time_", DT.TIME64NS), ("k", DT.INT64), ("s", DT.STRING),
                          (val, DT.INT64))
        cols = {"time_": np.arange(rows, dtype=np.int64),
                "k": rng.integers(0, MESH_JOIN_KEYS, rows).astype(np.int64),
                "s": services[rng.integers(0, N_SERVICES, rows)],
                val: rng.integers(0, 1 << 40, rows).astype(np.int64)}
        whole.create(side, rel, batch_rows=1 << 16).write(cols)
        per = rows // len(names)
        for i, a in enumerate(names):
            stores[a].create(side, rel, batch_rows=1 << 16).write(
                {c: v[i * per:(i + 1) * per] for c, v in cols.items()})
    return whole


def time_exchange(dev, store) -> dict:
    """One agent's left side (its 2^21 rows, every column) exchanged into
    MESH_SHARDS partitions in the mesh (X1, X2 with the uploads and the two
    readbacks) and on the host (partition_ids, split_host_batch): equal
    partitions, and the median wall of 3 of each."""
    from pixie_tpu_torch.engine.executor import HostBatch
    from pixie_tpu_torch.parallel import repartition as rp
    from pixie_tpu_torch.parallel.spmd import make_mesh

    t = store.table("left_t")
    hb = HostBatch({n: t.relation.dtype(n) for n in t.relation.names()},
                   dict(t.dictionaries), _table_columns(t, t.relation.names()))
    mesh = make_mesh(MESH_SHARDS, device=dev)
    keys = ["k", "s"]

    def host():
        return rp.split_host_batch(hb, rp.partition_ids(hb, keys, MESH_SHARDS), MESH_SHARDS)

    def in_mesh():
        return rp.mesh_partition_exchange(hb, keys, MESH_SHARDS, mesh)

    for a, b in zip(in_mesh(), host()):
        for c in hb.cols:
            if not np.array_equal(np.sort(a.cols[c]), np.sort(b.cols[c])):
                raise AssertionError(f"exchange: partition column {c} differs")
    return {"rows": hb.num_rows, "partitions": MESH_SHARDS,
            "mesh_s": warm_times(in_mesh, 1, 3)[1], "host_s": warm_times(host, 1, 3)[1]}


def run_mesh_cluster(dev) -> dict:
    """A LocalCluster of MESH_AGENTS agents, each a mesh of MESH_SHARDS
    co-located shards (n_devices_per_agent = 4): config #4's script over
    config #4's 16M rows (2 x 8M), equal to the n_devices_per_agent = 1
    cluster and to the oracle (every agent's shards merge by M1, then the
    agents by M1: 3 launches a query); then a repartitioned join of two
    MESH_JOIN_ROWS-row tables spread over both agents, keyed on (k int64, s string):
    each agent exchanges both sides in its mesh (X1, X2), four partition
    joins run, equal to the single-device join as sorted frames; then the
    same join with one agent at n_devices_per_agent = 1 (a host exchange
    beside a mesh exchange), equal again."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster

    out = {}
    with virtual_shards(MESH_SHARDS):
        t0 = time.perf_counter()
        stores, tables = _agent_stores(CONFIG4_ROWS // MESH_AGENTS, agents=MESH_AGENTS)
        data_s = time.perf_counter() - t0
        mesh_cl = LocalCluster(stores, device=dev, n_devices_per_agent=MESH_SHARDS)
        single_cl = LocalCluster(stores, device=dev, n_devices_per_agent=1)
        query = cluster_query(mesh_cl, dev, m1_launches=MESH_AGENTS + 1, p1_launches=0)
        _build.reset_launches()
        res = query()
        launches = read_launches("mesh config #4", CONFIG4_KERNELS)
        check = cluster_oracle(tables, res)
        spmd_feeds = res.exec_stats["transfer"]["spmd_feeds"]
        if spmd_feeds != res.exec_stats["feeds"]:
            raise AssertionError(f"mesh config #4: {spmd_feeds} SPMD feeds of "
                                 f"{res.exec_stats['feeds']}")
        want = cluster_query(single_cl, dev, m1_launches=1, p1_launches=0)()
        same_frame("mesh config #4", res, want, ["service", "status"], exact=("cnt", "p50"))
        routes = stream_and_warm(query, "mesh config #4")
        single_times = warm_times(cluster_query(single_cl, dev, m1_launches=1), 1, 5)
        out["config4"] = {"agents": MESH_AGENTS, "rows": CONFIG4_ROWS, "data_s": data_s,
                          **check, "spmd_feeds": spmd_feeds, **routes,
                          "rows_per_s": CONFIG4_ROWS / routes["warm_median_s"],
                          "single_device_warm_median_s": single_times[2]}
        log(json.dumps({"phase": "mesh_cluster.config4", "ok": True, **out["config4"]}))
        del mesh_cl, single_cl, tables

        # ---- the repartitioned join, over the same two agents' stores
        t0 = time.perf_counter()
        whole = _join_tables(stores, MESH_JOIN_ROWS, seed=23)
        data_s = time.perf_counter() - t0
        plan = compile_pxl(MESH_JOIN_SCRIPT, whole.schemas()).plan

        t0 = time.perf_counter()
        want = execute_plan(plan, whole, device=dev, mesh=None, analyze=True)["out"]
        single_s = time.perf_counter() - t0
        single_ops = [{"label": r["label"], "self_ms": r["self_ns"] / 1e6}
                      for r in want.exec_stats["operators"]]
        out["exchange"] = time_exchange(dev, stores["pem0"])
        log(json.dumps({"phase": "mesh_cluster.exchange", "ok": True, **out["exchange"]}))
        for label, agent1 in (("mesh", MESH_SHARDS), ("mixed", 1)):
            cl = LocalCluster(stores, device=dev, n_devices_per_agent=MESH_SHARDS)
            cl.spec.agents[1].n_devices = agent1
            if label == "mesh":
                _build.reset_launches()
            t0 = time.perf_counter()
            res = cl.query(MESH_JOIN_SCRIPT)["out"]
            torch.cuda.synchronize(dev)
            first_s = time.perf_counter() - t0
            if label == "mesh":
                launches = read_launches("mesh join", X_KERNELS) | {
                    k: v for k, v in launches.items() if k != "repartition"}
            same_rows(f"{label} join", res, want)
            shuffles = {a: s.get("mesh_shuffles", 0)
                        for a, s in res.exec_stats["agents"].items()}
            want_shuffles = {"pem0": 2, "pem1": 2 if agent1 > 1 else 0}
            if shuffles != want_shuffles:
                raise AssertionError(f"{label} join: mesh shuffles {shuffles}, "
                                     f"want {want_shuffles}")
            t0 = time.perf_counter()
            cl.query(MESH_JOIN_SCRIPT)
            torch.cuda.synchronize(dev)
            out[f"join_{label}"] = {"rows_a_side": MESH_JOIN_ROWS, "out_rows": res.num_rows,
                                    "mesh_shuffles": shuffles, "first_s": first_s,
                                    "second_s": time.perf_counter() - t0,
                                    "single_device_s": single_s,
                                    "single_device_operators": single_ops, "data_s": data_s}
            log(json.dumps({"phase": f"mesh_cluster.join_{label}", "ok": True,
                            **out[f"join_{label}"]}))
    out["launches"] = launches
    log(json.dumps({"phase": "slice.mesh_cluster", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out



# ------------------------------------------- unions, standing views, shard_bench

#: the union phase's script over config #1's table: the 500s and the 404s
#: (~15% of the rows) appended, then grouped by service
UNION_SCRIPT = """
df = px.DataFrame(table='http_events')
a = df[df.status == 500]
b = df[df.status == 404]
u = a.append(b)
u = u.groupby('service').agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(u, 'output')
"""
#: each parent: C1 and K4 over the table's feeds; the aggregate over the
#: union's host batch: one feed, one F1 launch
UNION_KERNELS = [C1, ("compact", "px_compact"), F1]
#: the view fold: C1, K1 and K2 over the delta, P1 packing the state
MATVIEW_FOLD_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                        ("segment_reduce", "px_segment_sum_f64"),
                        ("loghist_update", "px_loghist_update"), P1]
#: rows appended to pem0 before the view fold: 16 batches of 65,536
MATVIEW_APPEND = 1 << 20
#: warm view hits timed after the build
MATVIEW_HITS = 5
#: shard_bench's arms: run_local's rows, the join's rows a side
SHARD_LOCAL_ROWS = 1 << 26
SHARD_JOIN_ROWS = 1 << 21
SHARD_LOCAL_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                       ("loghist_update", "px_loghist_update"), F2]
#: the shuffled join: X1 and X2 exchange both sides, each partition's join
#: runs J1-J3
SHARD_JOIN_KERNELS = [("repartition", "px_partition_count"),
                      ("repartition", "px_partition_scatter"),
                      ("join", "px_join_build"), ("join", "px_join_probe"),
                      ("join", "px_join_expand")]


def union_oracle(table, res) -> dict:
    """numpy oracle of UNION_SCRIPT over the table's rows, held as
    oracle_check holds config #1; raises on mismatch."""
    cols = _table_columns(table, ("service", "latency", "status"))
    sel = (cols["status"] == 500) | (cols["status"] == 404)
    svc, lat = cols["service"][sel].astype(np.int64), cols["latency"][sel]
    ng = int(svc.max()) + 1
    cnt, mean, sketch_p50, median = sketch_oracle(svc, lat, ng)
    names = table.dictionaries["service"].values()
    got_key = np.array([names.index(v) for v in res.decoded("service")], dtype=np.int64)
    if res.num_rows != int((cnt > 0).sum()):
        raise AssertionError(f"union: groups {res.num_rows}, want {(cnt > 0).sum()}")
    if not np.array_equal(np.asarray(res.columns["cnt"]), cnt[got_key]):
        raise AssertionError("union: counts differ from the oracle")
    if not np.allclose(res.columns["avg_lat"], mean[got_key], rtol=1e-9, atol=0):
        raise AssertionError("union: means differ from the oracle beyond rtol 1e-9")
    exact, rel = check_p50(np.asarray(res.columns["p50"]), sketch_p50[got_key],
                           median[got_key])
    if not all(np.isfinite(np.asarray(res.columns[c], dtype=np.float64)).all()
               for c in ("cnt", "avg_lat", "p50")):
        raise AssertionError("union: non-finite results")
    return {"groups": res.num_rows, "union_rows": int(sel.sum()), "p50_exact_bin": exact,
            "p50_max_rel_err_vs_median": rel}


def run_union(dev, ts, table) -> dict:
    """UNION_SCRIPT from PxL text over config #1's 64M-row table: each
    parent's filtered scan through C1 and K4 (its feeds from the resident
    tier), the union on the host (dictionaries mapped onto the first
    parent's), the aggregate over the union's host batch (uploaded every
    query: one feed, F1).  Held against the numpy oracle; the median of 5
    warm runs, the launches and H2D bytes of one query."""
    import torch

    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build

    plan = compile_pxl(UNION_SCRIPT, ts.schemas()).plan

    def query():
        r = execute_plan(plan, ts, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    query()  # the tier admits the table's feeds if no phase did yet
    _build.reset_launches()
    res = query()
    launches = read_launches("union", UNION_KERNELS)
    check_leaves("union", res.exec_stats)
    check = union_oracle(table, res)
    times = warm_times(query, warmup=1, reps=5)
    out = {"launches": launches, **check, "warm_median_s": times[len(times) // 2],
           "warm_s": times, "h2d_bytes": res.exec_stats["h2d_bytes"],
           "feeds": res.exec_stats["feeds"],
           "resident_feeds": res.exec_stats.get("resident_feeds", 0),
           "fused_single_feed": res.exec_stats.get("fused_single_feed", 0),
           "operators": [{k: o[k] for k in ("label", "wall_ns", "rows_out")}
                         for o in res.exec_stats.get("operators", [])]}
    log(json.dumps({"phase": "slice.union", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


def run_matview(dev) -> dict:
    """Standing views on config #4's 8 agent stores of 2M rows (views on for
    this phase only).  Query 1 registers (a rescan: M1 once), query 2 builds
    (each agent's state computed and pulled to the host), queries 3-7 are
    hits with an empty delta (no row scanned, no C1 launch), then 2^20 rows
    are appended to pem0 and query 8 folds them (rows_folded 2^20 on pem0, 0
    elsewhere).  Every answer is held against a fresh views-off cluster
    over the same stores: cnt and p50 exactly, avg_lat to rtol 1e-12."""
    import torch

    from pixie_tpu_torch import flags
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster

    t0 = time.perf_counter()
    stores, tables = _agent_stores(CONFIG4_ROWS // CONFIG4_AGENTS)
    data_s = time.perf_counter() - t0

    def cold():
        res = LocalCluster(stores, device=dev).query(CONFIG4_SCRIPT)["output"]
        torch.cuda.synchronize(dev)
        return res

    want = cold()
    flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    try:
        cluster = LocalCluster(stores, device=dev)

        def query(label, m1: int):
            before = {lib: k.launches for lib, k in _build.KERNELS.items()}
            t = time.perf_counter()
            res = cluster.query(CONFIG4_SCRIPT)["output"]
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            ran = {lib: k.launches - before[lib] for lib, k in _build.KERNELS.items()}
            if ran["merge"] != m1:
                raise AssertionError(f"matview {label}: M1 launched {ran['merge']} times, "
                                     f"want {m1}")
            return res, wall, ran

        def views(res) -> dict:
            return {a: s.get("matview") or {} for a, s in res.exec_stats["agents"].items()}

        res, register_s, _ran = query("register", 1)
        same_frame("matview register", res, want, ["service", "status"], exact=("p50",))
        if any(views(res).values()):
            raise AssertionError("matview: the first sight served from a view")
        res, build_s, build_ran = query("build", 0)
        same_frame("matview build", res, want, ["service", "status"], exact=("p50",))
        mv = views(res)
        per_agent = CONFIG4_ROWS // CONFIG4_AGENTS
        if not all(i.get("hit") and i["rows_folded"] == per_agent for i in mv.values()):
            raise AssertionError(f"matview build: {mv}")
        build_h2d = sum(i["h2d_bytes"] for i in mv.values())
        hits = []
        for q in range(MATVIEW_HITS):
            res, wall, ran = query(f"hit {q}", 0)
            same_frame("matview hit", res, want, ["service", "status"], exact=("p50",))
            scanned = sum(i["rows_folded"] for i in views(res).values())
            if scanned or ran["chain"] or not all(i.get("hit") for i in views(res).values()):
                raise AssertionError(f"matview hit {q}: {scanned} rows folded, "
                                     f"{ran['chain']} C1 launches")
            hits.append(wall)
        hits.sort()
        gen = HttpRows(tables[0], per_agent)  # the table's time step, another seed
        gen.rng = np.random.default_rng(13)
        gen.written = per_agent
        gen.write(MATVIEW_APPEND)
        _build.reset_launches()
        res, fold_s, _ran = query("fold", 0)
        fold_launches = read_launches("matview fold", MATVIEW_FOLD_KERNELS)
        mv = views(res)
        folded = {a: i["rows_folded"] for a, i in mv.items()}
        if folded != {a: (MATVIEW_APPEND if a == "pem0" else 0) for a in mv}:
            raise AssertionError(f"matview fold: rows folded {folded}")
        flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        same_frame("matview fold", res, cold(), ["service", "status"], exact=("p50",))
    finally:
        flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    out = {"agents": CONFIG4_AGENTS, "rows": CONFIG4_ROWS, "data_s": data_s,
           "register_s": register_s, "build_s": build_s,
           "build_h2d_bytes": build_h2d,
           "build_launches": {k: v for k, v in build_ran.items() if v},
           "hit_median_s": hits[len(hits) // 2], "hit_s": hits,
           "fold_s": fold_s, "fold_rows": MATVIEW_APPEND,
           "fold_h2d_bytes": mv["pem0"]["h2d_bytes"],
           "fold_refresh_ms": mv["pem0"]["refresh_ms"],
           "fold_launches": {lib: {e: n for e, n in by.items() if n}
                             for lib, by in fold_launches.items() if any(by.values())},
           "state_bytes": mv["pem0"]["state_bytes"], "groups": mv["pem0"]["groups"]}
    log(json.dumps({"phase": "slice.matview", "ok": True, **out}))
    out["launches"] = fold_launches
    return out


def run_shard_bench(dev) -> dict:
    """parallel/shard_bench.py's one-process arms on the card, over 4
    co-located shards: run_local (filter → map → partial agg over 64M rows,
    each shard's C1, K1 and K2, F2 over the shards' states, bit-equal to
    the single-device executor) and run_shuffled_join (2^21 rows a side, one
    agent's mesh exchanging both sides with X1 and X2, each partition joined
    by J1-J3, bit-equal to the single-device join).  Each arm's launches are
    read from one more warm query of its path alone, on the arm's store:
    the arm's own runs (cold, warm, the single-device comparison) are not
    counted."""
    import torch

    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import shard_bench
    from pixie_tpu_torch.parallel.cluster import LocalCluster
    from pixie_tpu_torch.parallel.spmd import make_mesh

    def launched(launches):
        return {lib: {e: n for e, n in by.items() if n}
                for lib, by in launches.items() if any(by.values())}

    with virtual_shards(MESH_SHARDS):
        ts = shard_bench.build_store(SHARD_LOCAL_ROWS)
        t0 = time.perf_counter()
        local = shard_bench.run_local(SHARD_LOCAL_ROWS, repeats=3, n_devices=MESH_SHARDS,
                                      device=dev, store=ts)
        local["wall_s"] = time.perf_counter() - t0
        if local["bit_equal"] is not True or local["spmd_feeds"] < 1:
            raise AssertionError(f"shard_bench run_local: {local}")
        query = PlanExecutor(shard_bench.agg_plan(), ts, device=dev,
                             mesh=make_mesh(MESH_SHARDS, device=dev))
        _build.reset_launches()
        query.run()
        torch.cuda.synchronize()
        local_launches = read_launches("shard_bench run_local", SHARD_LOCAL_KERNELS)
        local["launches"] = launched(local_launches)
        log(json.dumps({"phase": "shard_bench.run_local", "ok": True, **local}))
        del ts, query
        ts = shard_bench.build_join_store(SHARD_JOIN_ROWS)
        t0 = time.perf_counter()
        join = shard_bench.run_shuffled_join(SHARD_JOIN_ROWS, n_devices=MESH_SHARDS,
                                             device=dev, store=ts)
        join["wall_s"] = time.perf_counter() - t0
        if join["bit_equal"] is not True or join["all_to_all_exchanges"] < 2:
            raise AssertionError(f"shard_bench run_shuffled_join: {join}")
        cluster = LocalCluster({"pem0": ts}, device=dev, n_devices_per_agent=MESH_SHARDS)
        plan = shard_bench.join_plan()
        _build.reset_launches()
        cluster.execute(plan)
        torch.cuda.synchronize()
        join_launches = read_launches("shard_bench run_shuffled_join", SHARD_JOIN_KERNELS)
        join["launches"] = launched(join_launches)
        log(json.dumps({"phase": "shard_bench.run_shuffled_join", "ok": True, **join}))
    return {"local_launches": local_launches, "join_launches": join_launches}


# ----------------------------------------------------- the mesh across processes
#: bench.py's sharded_agg_64m: 64M rows over 2 processes x 4 shards (two
#: ranks sharing the one card over gloo), 3 repeats; the exchange's rows a rank
MULTIHOST_ROWS = 64_000_000
MULTIHOST_PROCESSES = 2
MULTIHOST_SHARDS = 4
MULTIHOST_EXCHANGE_ROWS = 1 << 21
#: a rank's step: each local shard's C1, K1 and K2, M1 twice (the local
#: merge, then the world's buffers)
MULTIHOST_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
                     ("segment_reduce", "px_segment_sum_i64"),
                     ("segment_reduce", "px_segment_min_f64"),
                     ("segment_reduce", "px_segment_max_f64"),
                     ("loghist_update", "px_loghist_update"), ("merge", "px_merge_states")]
#: a rank's exchange: X1, X2, then K4 closing the blocks' gaps
MULTIHOST_EXCHANGE_KERNELS = [("repartition", "px_partition_count"),
                              ("repartition", "px_partition_scatter"), ("compact", "px_compact")]


def _rank_launches(phase: str, rank: int, launches: dict, required) -> dict:
    """A worker's reported launches ({lib: {entry: n}}), every library
    present; raises if a kernel of the phase did not launch on the rank."""
    from pixie_tpu_torch.ops import _build

    missing = [f"{lib}.{e}" for lib, e in required if not launches.get(lib, {}).get(e)]
    if missing:
        raise AssertionError(f"kernels not launched on rank {rank} of the {phase} path: "
                             f"{missing}")
    return {lib: dict(launches.get(lib, {})) for lib in _build.KERNELS}


def run_nccl_world(dev) -> dict:
    """A one-rank NCCL world in this process: the world merge (M1 over 4
    local shards of config #1's state, one NCCL all_gather, the world's one
    buffer) equal bit for bit to M1 over the same states and to its plain
    version; its launches (M1 once) read from the merge alone."""
    import torch

    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.ops import merge as m1
    from pixie_tpu_torch.ops.pack import flatten
    from pixie_tpu_torch.parallel import multihost, spmd
    from pixie_tpu_torch.udf.udf import tree_map

    rng = np.random.default_rng(20)
    g = 64
    rt = {"cnt": "add", "avg_lat": {"sum": "add", "count": "add"}, "p50": "add",
          "__seen": "add", "lo": "min", "hi": "max"}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with virtual_shards(MESH_SHARDS):
        if not multihost.init_multihost(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                        device="cuda"):
            raise AssertionError("the one-rank world did not start")
        try:
            desc = multihost.describe()
            if desc["backend"] != "nccl":
                raise AssertionError(f"one rank on one card is not NCCL: {desc}")
            mesh = multihost.global_mesh()
            sts = [tree_map(lambda a: torch.from_numpy(a).to(dev), {
                "cnt": rng.integers(0, 1 << 20, g),
                "avg_lat": {"sum": rng.exponential(50.0, g) * 1e4,
                            "count": rng.integers(0, 1 << 20, g)},
                "p50": rng.integers(0, 1 << 12, (g, WIDTH)).astype(np.float32),
                "__seen": rng.integers(0, 1 << 20, g),
                "lo": rng.normal(size=g), "hi": rng.normal(size=g)})
                for _ in range(mesh.local_size)]
            spmd.collective_merge(sts, rt, mesh=mesh)  # the layout check
            multihost.reset_exec_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            got = spmd.collective_merge(sts, rt, mesh=mesh)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000
            launches = read_launches("nccl_world", [("merge", "px_merge_states")])
            stats = multihost.exec_stats()
            want = m1.merge_states(rt, sts)
            plain = m1.merge_states_plain(rt, sts)
            torch.cuda.synchronize()
            if not torch.equal(got.buf, want.buf):
                raise AssertionError("NCCL world merge != M1 over the same states")
            if not all(same_bits(a, b) for (_p, a), (_q, b) in zip(flatten(got.tree()),
                                                                    flatten(plain))):
                raise AssertionError("NCCL world merge != M1's plain version")
            gloo_cuda = gloo_takes_cuda(dev)
            out = {"backend": desc["backend"], "processes": 1, "shards": mesh.local_size,
                   "gloo_takes_cuda_tensors": gloo_cuda,
                   "m1_launches": launches["merge"]["px_merge_states"],
                   "gathered_bytes": stats["gathered_bytes"],
                   "staged_bytes": stats["staged_bytes"], "wall_ms": wall_ms,
                   "state_bytes": got.layout.nbytes, "bit_equal": True}
        finally:
            multihost.shutdown()
    log(json.dumps({"phase": "multihost.nccl_world", "ok": True, **out}))
    out["launches"] = launches
    return out


def gloo_takes_cuda(dev) -> dict:
    """Whether this torch build's gloo takes CUDA tensors in all_gather and
    all_to_all_single (a one-rank gloo group beside the world): the port
    stages them through pinned host memory either way."""
    import torch
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    x = torch.arange(8, dtype=torch.int64, device=dev)
    got = {}
    for name, call in (("all_gather", lambda: dist.all_gather([torch.empty_like(x)], x,
                                                               group=group)),
                       ("all_to_all_single", lambda: dist.all_to_all_single(
                           torch.empty_like(x), x, group=group))):
        try:
            call()
            torch.cuda.synchronize()
            got[name] = True
        except RuntimeError as e:
            got[name] = f"refused: {str(e).splitlines()[0][:120]}"
    dist.destroy_process_group(group)
    return got


def run_multihost_phase(dev, smi: str) -> dict:
    """parallel/shard_bench.py's multi-process arm on the card: run_subprocess
    at bench.py's sharded_agg_64m size (64M rows, 2 processes x 4 shards,
    both ranks on this one card, so gloo with pinned staging: not a
    multi-card figure) with the exchange at 2^21 rows a rank; rank 0
    bit-equal to the single-device step, both ranks the same merged bytes,
    every rank's step launching C1, K1, K2 and M1 twice and its exchange X1,
    X2 and K4.  Then the one-rank NCCL world (run_nccl_world)."""
    from pixie_tpu_torch.parallel import shard_bench

    t0 = time.perf_counter()
    doc = shard_bench.run_subprocess(MULTIHOST_ROWS, repeats=3, processes=MULTIHOST_PROCESSES,
                                     devices_per_proc=MULTIHOST_SHARDS, timeout=900.0,
                                     device="cuda", exchange_rows=MULTIHOST_EXCHANGE_ROWS)
    wall = time.perf_counter() - t0
    if (doc["mode"] != "multihost" or doc["bit_equal"] is not True
            or doc["ranks_equal"] is not True or doc["n_devices"] != 8):
        raise AssertionError(f"multihost run_subprocess: {doc}")
    paths = {}
    for r in doc["ranks"]:
        got = _rank_launches("multihost", r["rank"], r["launches"], MULTIHOST_KERNELS)
        if got["merge"].get("px_merge_states") != 2:
            raise AssertionError(f"rank {r['rank']}: M1 launched "
                                 f"{got['merge'].get('px_merge_states')} times a step, not 2")
        x = _rank_launches("multihost exchange", r["rank"], r["exchange"]["launches"],
                           MULTIHOST_EXCHANGE_KERNELS)
        if not r["exchange"]["rows_equal"]:
            raise AssertionError(f"rank {r['rank']}: the exchange's rows differ")
        if r["rank"] == 0:
            paths["multihost"], paths["multihost_exchange"] = got, x
    log(json.dumps({"phase": "multihost.sharded_agg", "ok": True, "card": smi,
                    "shared_card": True, "backend": doc["backend"],
                    "processes": doc["processes"], "shards_per_process": doc["shards_per_process"],
                    "rows": doc["rows"], "rows_per_sec": doc["rows_per_sec"],
                    "p50_ms": doc["p50_ms"], "bit_equal": doc["bit_equal"],
                    "ranks_equal": doc["ranks_equal"], "wall_s": wall}))
    for r in doc["ranks"]:
        log(json.dumps({"phase": "multihost.rank", "rank": r["rank"], "p50_ms": r["p50_ms"],
                        "launches_a_step": r["launches"],
                        "world_merge": {"gathered_bytes": r["gathered_bytes"],
                                        "staged_bytes": r["staged_bytes"],
                                        "wall_ms": r["world_merge_ms"]}}))
        x = r["exchange"]
        log(json.dumps({"phase": "multihost.exchange", "rank": r["rank"], "card": smi,
                        "rows_per_rank": x["rows_per_rank"], "sent_bytes": x["sent_bytes"],
                        "recv_bytes": x["recv_bytes"], "staged_bytes": x["staged_bytes"],
                        "all_to_all_calls": x["all_to_all_calls"], "wall_ms": x["wall_ms"],
                        "launches": x["launches"], "rows_equal": x["rows_equal"]}))
    paths["nccl_world"] = run_nccl_world(dev)["launches"]
    return paths


#: the cpu_route phase's sweep: config #1 over build_http_table at these sizes
CPU_ROUTE_SIZES = [1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24]
#: the np_partial query's rows, config #4's stores for the cluster decision,
#: and the native join's rows a side
NP_PARTIAL_ROWS = 1 << 20
CLUSTER_ROUTE_ROWS = 1 << 18
NATIVE_JOIN_ROWS = 1 << 16


#: the flags that pin every phase before cpu_route to the card route: no
#: size routes to the CPU and no autotune gate (the CPU route's, the join
#: gate's, mq fusion's) probes another arm
# ------------------------------------------------------------ the host layers

#: the host-layer phase's config #1 runs: C1, K1, K2, F2 (and R1 admitting)
HOST_LAYERS_KERNELS = CONFIG1_KERNELS
#: rows of the tablets check (cut from config #1's 64M: TabletsGroup.write
#: routes each 2^21-row chunk by a host np.unique over its strings, 2.7 s a
#: chunk on the card's host)
TABLET_ROWS = 1 << 22
#: the cold-tier run's sealed-RAM ceiling a store (MB): 2^21 rows in 32
#: batches of 65,536 x 28 B (1.84 MB each) hold ~59 MB, so about half demote
COLD_CEILING_MB = 29


def _held(label: str, got, want, keys) -> dict:
    """same_frame (counts and p50 exactly, means to rtol 1e-12: K1's float64
    sums add in a different order each run), and how many mean cells are
    bit-identical."""
    same_frame(label, got, want, keys, exact=("p50",))
    g = got.to_pandas().sort_values(keys).reset_index(drop=True)
    w = want.to_pandas().sort_values(keys).reset_index(drop=True)
    bits = int((g["avg_lat"].to_numpy().view(np.int64)
                == w["avg_lat"].to_numpy().view(np.int64)).sum())
    return {"groups": len(g), "avg_lat_bit_identical": bits}


def _relation(res) -> list:
    return [[c.name, c.data_type.name, c.semantic_type.name] for c in res.relation]


def host_layers_config1(dev, smi: str) -> dict:
    """(a) config #1 over build_http_table's 64M rows with tracing on and
    off; (b) its semantic types against the port's CPU run; (f) tablets."""
    import torch

    from pixie_tpu_torch import flags
    from pixie_tpu_torch import observe
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.plan import MemorySourceOp
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.table import heat

    t0 = time.perf_counter()
    ts = TableStore()
    table, _gen = build_http_table(ts, ROWS, semantic=True)
    log(json.dumps({"phase": "host_layers.data", "rows": ROWS, "card": smi,
                    "seconds": time.perf_counter() - t0}))
    plan = http_plan()

    def query():
        r = execute_plan(plan, ts, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    # (a) the first query with tracing on: the path's launches and heat
    flags.set_for_testing("PL_TRACING_ENABLED", True)
    heat.reset_for_testing()
    _build.reset_launches()
    first = query()
    launches = read_launches("host_layers config #1", HOST_LAYERS_KERNELS)
    cells = heat.snapshot_rows()
    heat_rows = sum(r["rows_scanned"] for r in cells)
    if heat_rows != first.exec_stats["rows_scanned"] or heat_rows != ROWS:
        raise AssertionError(f"host_layers: heat counts {heat_rows} rows, the query "
                             f"scanned {first.exec_stats['rows_scanned']}")
    oracle_check(table, first)
    medians, results = {}, {}
    for on in (True, False, True, False):  # alternating, each arm twice
        flags.set_for_testing("PL_TRACING_ENABLED", on)
        times = warm_times(query, warmup=2, reps=5)
        medians.setdefault(on, []).append(times[len(times) // 2])
        results[on] = query()
    flags.set_for_testing("PL_TRACING_ENABLED", True)
    held = _held("host_layers tracing on/off", results[True], results[False],
                 ["service", "status"])
    warm_copies = h2d_copies(query)
    if warm_copies["h2d_per_call"]:
        raise AssertionError(f"host_layers: a warm traced query copied to the card: "
                             f"{warm_copies}")
    # the same through LocalCluster (profile, op_stats, verification,
    # restamp), each arm's cluster made under its own setting, alternating
    clusters = {}
    for on in (True, False):
        flags.set_for_testing("PL_TRACING_ENABLED", on)
        clusters[on] = LocalCluster({"pem0": ts}, device=dev)

    def cquery(cluster):
        r = cluster.query(CONFIG4_SCRIPT)["output"]
        torch.cuda.synchronize(dev)
        return r

    cl_medians = {}
    for on in (True, False, True, False):
        flags.set_for_testing("PL_TRACING_ENABLED", on)
        times = warm_times(lambda: cquery(clusters[on]), warmup=2, reps=5)
        cl_medians.setdefault(on, []).append(times[len(times) // 2])
    flags.set_for_testing("PL_TRACING_ENABLED", True)
    clusters[True].flush_telemetry()
    written = {t: ts.table(t).stats()["rows_written"]
               for t in (observe.PROFILES_TABLE, observe.OP_STATS_TABLE)}
    profile = cquery(clusters[True]).exec_stats["profile"]
    if written[observe.PROFILES_TABLE] != 14:
        raise AssertionError(f"host_layers: profile rows written {written}")
    a = {"rows": ROWS, "card": smi,
         "warm_median_s_tracing_on": min(medians[True]),
         "warm_median_s_tracing_off": min(medians[False]),
         "warm_medians_s": {"on": medians[True], "off": medians[False]},
         "cluster_warm_median_s_tracing_on": min(cl_medians[True]),
         "cluster_warm_median_s_tracing_off": min(cl_medians[False]),
         "cluster_warm_medians_s": {"on": cl_medians[True], "off": cl_medians[False]},
         "profile_rows_written": written[observe.PROFILES_TABLE],
         "op_stats_rows_written": written[observe.OP_STATS_TABLE],
         "heat_rows_scanned": heat_rows, "heat_cells": len(cells),
         "heat_tiers": sorted({r["tier"] for r in cells}),
         "warm_h2d_copies": warm_copies["h2d_per_call"], **held,
         "profile_warm": {k: profile[k] for k in ("wall_ns", "exec_ns", "merge_ns",
                                                   "rows_scanned", "h2d_bytes",
                                                   "plan_cache_hit", "split_cache_hit",
                                                   "resident_feeds")}}
    log(json.dumps({"phase": "host_layers.tracing", "ok": True, **a}))

    # (b) semantic types: the card's relation against the CPU run's
    small = TableStore()
    build_http_table(small, 1 << 20, semantic=True)
    cpu = execute_plan(plan, small, device="cpu")["output"]
    got, want = _relation(first), _relation(cpu)
    if got != want or dict((n, st) for n, _d, st in got) != {
            "service": "ST_SERVICE_NAME", "status": "ST_NONE", "cnt": "ST_NONE",
            "avg_lat": "ST_DURATION_NS", "p50": "ST_DURATION_NS"}:
        raise AssertionError(f"host_layers: semantic types {got} against the CPU's {want}")
    log(json.dumps({"phase": "host_layers.semantic_types", "ok": True, "card": smi,
                    "relation": got}))

    # (f) tablets: config #1's rows (cut to TABLET_ROWS) as 16 tablets
    t0 = time.perf_counter()
    tts, plain = TableStore(), TableStore()
    group, _g = build_http_table(tts, TABLET_ROWS, semantic=True, tablet_col="service")
    build_http_table(plain, TABLET_ROWS, semantic=True)
    write_s = time.perf_counter() - t0
    if group.tablet_ids() != sorted(f"svc-{i}" for i in range(N_SERVICES)):
        raise AssertionError(f"host_layers: tablets {group.tablet_ids()}")
    whole = execute_plan(plan, tts, device=dev)["output"]
    want_all = execute_plan(plan, plain, device=dev)["output"]
    held_all = _held("host_layers tablets whole group", whole, want_all, ["service", "status"])
    tplan = http_plan()
    src = next(op for op in tplan.ops() if isinstance(op, MemorySourceOp))
    src.tablet = "svc-3"
    one = execute_plan(tplan, tts, device=dev)["output"]
    df_all = want_all.to_pandas()
    df_one = one.to_pandas().sort_values("status").reset_index(drop=True)
    sub = df_all[df_all["service"] == "svc-3"].sort_values("status").reset_index(drop=True)
    if (df_one["cnt"].tolist() != sub["cnt"].tolist()
            or df_one["p50"].tolist() != sub["p50"].tolist()
            or not np.allclose(df_one["avg_lat"], sub["avg_lat"], rtol=1e-12, atol=0)):
        raise AssertionError("host_layers: the one-tablet query differs from the plain "
                             "answer restricted to its service")
    for _ in range(2):  # warm: the tablets' feeds must not alias in the caches
        again = execute_plan(tplan, tts, device=dev)["output"]
        same_frame("host_layers tablet warm", again, one, ["status"], exact=("p50",))
    f = {"rows": TABLET_ROWS, "tablets": len(group.tablet_ids()), "write_s": write_s,
         "card": smi, "whole_group": held_all, "one_tablet_groups": len(df_one)}
    log(json.dumps({"phase": "host_layers.tablets", "ok": True, **f}))
    return {"launches": launches, "tracing": a, "tablets": f}


def host_layers_cluster(dev, smi: str) -> dict:
    """(c) config #4 over LocalCluster with EXPLAIN and plan verification;
    (d) the journal; (e) the cold tier; (g) a view snapshot."""
    import copy
    import shutil
    import tempfile

    import torch

    from pixie_tpu_torch import flags, metrics
    from pixie_tpu_torch.check import planverify
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import resident
    from pixie_tpu_torch.engine import executor as _executor
    from pixie_tpu_torch.matview import MatViewManager
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.plan import Column, MapOp, Plan
    from pixie_tpu_torch.table import TableStore, heat, journal, lifecycle

    rows_each = CONFIG4_ROWS // CONFIG4_AGENTS
    out: dict = {"card": smi}
    # (c) config #4: EXPLAIN, one verification cold and none warm
    t0 = time.perf_counter()
    stores, tables = _agent_stores(rows_each)
    plain_s = time.perf_counter() - t0
    cluster = LocalCluster(stores, device=dev)
    v0 = metrics.counter_value("px_plan_verify_total")
    live = cluster.query(CONFIG4_SCRIPT, explain=True)["output"]
    torch.cuda.synchronize(dev)
    v1 = metrics.counter_value("px_plan_verify_total")
    cluster_oracle(tables, live)
    text = live.exec_stats["explain"]
    op_lines = [ln.split() for ln in text.splitlines()
                if ln.startswith("  pem") and "partial_agg" in ln]
    if ("torch.cuda.synchronize" not in text or len(op_lines) != CONFIG4_AGENTS
            or not all(float(p[2].rstrip("ms")) > 0 for p in op_lines)):
        raise AssertionError(f"host_layers: EXPLAIN ANALYZE lacks synchronized op times:\n{text}")
    for _ in range(5):
        cluster.query(CONFIG4_SCRIPT)
    v2 = metrics.counter_value("px_plan_verify_total")
    if (v1 - v0, v2 - v1) != (1, 0):
        raise AssertionError(f"host_layers: verified {v1 - v0} times cold, {v2 - v1} warm")
    # a dtype flipped across a shuffle: refused before any launch
    limit_src = "df = px.DataFrame(table='http_events')\ndf = df.head(20)\npx.display(df, 'o')\n"
    q = compile_pxl(limit_src, cluster.schemas())
    real = cluster.planner

    class Flip:
        """The planner, with one agent's LIMIT fragment re-typing latency
        (FLOAT64) as status (INT64) before it ships."""

        def plan(self, logical):
            dp = real.plan(logical)
            victim = sorted(dp.agent_plans)[1]
            ops = [copy.copy(o) for o in dp.agent_plans[victim].topo_sorted()]
            *chain, sink = ops
            cast = MapOp(exprs=[("time_", Column("time_")), ("service", Column("service")),
                                ("latency", Column("status")), ("status", Column("status"))])
            new, node = Plan(), None
            for op in chain + [cast, sink]:
                op.id = -1
                node = new.add(op, parents=[] if node is None else [node])
            dp.agent_plans[victim] = new
            return dp

    cluster.planner = Flip()
    before = _launch_total()
    try:
        cluster.execute(q.plan)
    except planverify.PlanVerifyError as e:
        if e.invariant != "shuffle-schema-mismatch":
            raise
        refused = e.invariant
    else:
        raise AssertionError("host_layers: a dtype flipped across a shuffle was not refused")
    finally:
        cluster.planner = real
    if _launch_total() != before:
        raise AssertionError("host_layers: a refused split launched a kernel")
    out["explain"] = {"verify_cold": int(v1 - v0), "verify_warm_5": int(v2 - v1),
                      "refused": refused, "op_ns_synchronized": True,
                      "agent_op_ms": [float(p[2].rstrip("ms")) for p in op_lines]}
    log(json.dumps({"phase": "host_layers.explain", "ok": True, "card": smi,
                    **out["explain"]}))
    log(text)

    base = tempfile.mkdtemp(prefix="px_host_layers_")
    saved = {k: flags.get(k) for k in ("PL_DATA_DIR", "PL_COLD_TIER", "PL_COLD_MAX_HOT_MB",
                                       "PL_COLD_AFTER_S", "PL_MATVIEW_ENABLED")}
    try:
        # (d) the journal: ingest with it on, replay, answer as live
        flags.set_for_testing("PL_DATA_DIR", base)
        jstores = {}
        t0 = time.perf_counter()
        for a in range(CONFIG4_AGENTS):
            st = TableStore()
            t, _g = build_http_table(st, 0)
            journal.attach_store(st, journal.node_dir(f"pem{a}"))
            HttpRows(t, rows_each).write(rows_each)
            jstores[f"pem{a}"] = st
        journal_s = time.perf_counter() - t0
        jbytes = sum(s.table("http_events").journal.disk_usage()[0] for s in jstores.values())
        for st in jstores.values():
            journal.detach_store(st)
        t0 = time.perf_counter()
        replayed = {}
        for a in range(CONFIG4_AGENTS):
            st = TableStore()
            stats = journal.attach_store(st, journal.node_dir(f"pem{a}"))
            journal.detach_store(st)
            if stats["rows"] != rows_each:
                raise AssertionError(f"host_layers: replay restored {stats}")
            replayed[f"pem{a}"] = st
        replay_s = time.perf_counter() - t0
        got = LocalCluster(replayed, device=dev).query(CONFIG4_SCRIPT)["output"]
        torch.cuda.synchronize(dev)
        held = _held("host_layers journal replay", got, live, ["service", "status"])
        out["journal"] = {"rows": CONFIG4_ROWS, "fsync": flags.get("PL_JOURNAL_FSYNC"),
                          "ingest_rows_per_s_without": CONFIG4_ROWS / plain_s,
                          "ingest_rows_per_s_with": CONFIG4_ROWS / journal_s,
                          "ingest_s_without": plain_s, "ingest_s_with": journal_s,
                          "journal_bytes": jbytes, "replay_s": replay_s,
                          "replay_rows_per_s": CONFIG4_ROWS / replay_s, **held}
        log(json.dumps({"phase": "host_layers.journal", "ok": True, "card": smi,
                        **out["journal"]}))
        del jstores, replayed

        # (e) the cold tier: about half the sealed batches demote on write
        flags.set_for_testing("PL_COLD_TIER", 1)
        flags.set_for_testing("PL_COLD_AFTER_S", 0.0)
        flags.set_for_testing("PL_COLD_MAX_HOT_MB", COLD_CEILING_MB)
        cstores, ctables = {}, []
        t0 = time.perf_counter()
        for a in range(CONFIG4_AGENTS):
            st = TableStore()
            t, _g = build_http_table(st, 0)
            lifecycle.attach_table(t, os.path.join(base, f"cold{a}"))
            HttpRows(t, rows_each).write(rows_each)
            cstores[f"pem{a}"] = st
            ctables.append(t)
        demote_s = time.perf_counter() - t0
        flags.set_for_testing("PL_COLD_MAX_HOT_MB", 0)  # no headroom gate for promotion
        n_sealed = sum(len(t._sealed) for t in ctables)
        cold_gens = [{sb.gen for sb in t._sealed if getattr(sb, "is_cold", False)}
                     for t in ctables]
        n_cold = sum(len(g) for g in cold_gens)
        if not 0.3 * n_sealed <= n_cold <= 0.7 * n_sealed:
            raise AssertionError(f"host_layers: {n_cold} of {n_sealed} batches demoted")
        ccluster = LocalCluster(cstores, device=dev)
        heat.reset_for_testing()
        reads = []
        for i in range(int(flags.get("PL_COLD_PROMOTE_READS"))):
            t0 = time.perf_counter()
            res = ccluster.query(CONFIG4_SCRIPT)["output"]
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            promoted = sum(t.cold.promotions for t in ctables)
            h2d = sum(s.get("h2d_bytes", 0) for s in res.exec_stats["agents"].values())
            reads.append({"query_s": wall, "promoted": promoted, "h2d_bytes": h2d})
            _held(f"host_layers cold query {i}", res, live, ["service", "status"])
            for t, gens in zip(ctables, cold_gens):
                for key, entry in list(resident._TIER.items()):
                    if key[0] == t.uid and entry.gen_lo <= max(gens):
                        raise AssertionError("host_layers: a cold batch is resident")
                for key in list(_executor._DEVICE_CACHE):
                    if key[0] == t.uid and set(key[1]) & gens:
                        raise AssertionError("host_layers: a cold batch is in the feed cache")
        tiers = {}
        for r in heat.snapshot_rows():
            tiers[r["tier"]] = tiers.get(r["tier"], 0) + r["rows_scanned"]
        if ([r["promoted"] for r in reads[:-1]] != [0] * (len(reads) - 1)
                or reads[-1]["promoted"] != n_cold or "cold" not in tiers):
            raise AssertionError(f"host_layers: promotion {reads}, heat tiers {tiers}")
        after = ccluster.query(CONFIG4_SCRIPT)["output"]
        _held("host_layers promoted", after, live, ["service", "status"])
        demotions = sum(t.cold.stats()["demotions"] for t in ctables)
        cold_disk = sum(t.cold.stats()["cold_bytes"] for t in ctables)
        out["cold"] = {"sealed_batches": n_sealed, "demoted": n_cold,
                       "demote_write_s": demote_s, "queries": reads, "heat_tiers": tiers,
                       "promoted": reads[-1]["promoted"], "demotions": demotions,
                       "cold_disk_bytes_after": cold_disk,
                       "promote_reads": int(flags.get("PL_COLD_PROMOTE_READS"))}
        log(json.dumps({"phase": "host_layers.cold", "ok": True, "card": smi, **out["cold"]}))
        del ccluster, cstores, ctables

        # (g) a view snapshot: restored, it serves the live hit's state
        flags.set_for_testing("PL_MATVIEW_ENABLED", True)
        agent_plan = cluster.planner.plan(
            compile_pxl(CONFIG4_SCRIPT, cluster.schemas()).plan).agent_plans["pem0"]
        snap_dir = os.path.join(base, "snapshots")
        mgr = MatViewManager(stores["pem0"], device=dev)
        mgr.set_snapshot_dir(snap_dir)
        mgr.serve(agent_plan)  # first sight registers
        _cid, live_pb, info = mgr.serve(agent_plan)
        restored = MatViewManager(stores["pem0"], device=dev)
        restored.set_snapshot_dir(snap_dir)
        t0 = time.perf_counter()
        _cid, snap_pb, sinfo = restored.serve(agent_plan)
        restore_s = time.perf_counter() - t0
        if sinfo["rows_folded"] or live_pb.to_bytes() != snap_pb.to_bytes():
            raise AssertionError("host_layers: the restored view differs from the live hit")
        out["snapshot"] = {"rows_folded_live": info["rows_folded"], "restore_s": restore_s,
                           "state_bytes": len(live_pb.to_bytes()),
                           "files": len(os.listdir(snap_dir))}
        log(json.dumps({"phase": "host_layers.snapshot", "ok": True, "card": smi,
                        **out["snapshot"]}))
    finally:
        for k, v in saved.items():
            flags.set_for_testing(k, v)
        shutil.rmtree(base, ignore_errors=True)
    return out


def run_host_layers(dev, smi: str) -> dict:
    """The host layers on the card: (a)-(b), (f) over config #1's table,
    then (c)-(e), (g) over config #4's stores."""
    first = host_layers_config1(dev, smi)
    rest = host_layers_cluster(dev, smi)
    return {**first, **rest}


# ------------------------------------------------- slice 22: metadata_collect
#: the metadata_collect phase: the canonical http_events relation (the port's
#: collect/schemas.py, all 18 columns) at config #1's rows; 1,024 UPIDs over
#: 4 nodes (asid 1-4) bound to 256 pods of 16 services in 4 namespaces, 64
#: more with no pod
MD_BOUND, MD_UNBOUND, MD_PODS, MD_NODES = 1024, 64, 256, 4
MD_UPIDS = MD_BOUND + MD_UNBOUND
#: pods recreated under another service at the epoch change; the service
#: renamed there
MD_MOVED_PODS, MD_RENAMED = 32, 5
#: a cluster agent's rows (4 agents, one a node), the replayed rows and the
#: rows seq_gen writes while the queries run
MD_AGENT_ROWS = 1 << 22
MD_SEQ_ROWS = 1 << 22
MD_REPLAY_ROWS = 1 << 22
MD_CHUNK = 1 << 21
MD_SCRIPT = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status != 404]
df.service = df.ctx['service']
df.namespace = df.ctx['namespace']
df = df.groupby(['service', 'resp_status']).agg(
    cnt=('latency', px.count), total=('latency', px.sum),
    avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""
#: the ctx query over 4 feeds: C1 (the LUT over the UPID codes), K1's count,
#: int64 sum (total) and float64 sum (the mean), K2 (p50 of int64
#: latencies), F2
MD_KERNELS = [C1, ("segment_reduce", "px_segment_count"),
              ("segment_reduce", "px_segment_sum_i64"),
              ("segment_reduce", "px_segment_sum_f64"),
              ("loghist_update", "px_loghist_update"), F2]
#: the reference's UDTF relations (pixie_tpu/udf/udtf.py register_builtin_udtfs)
MD_UDTF_COLUMNS = {
    "GetAgentStatus": ["agent_id", "asid", "hostname", "ip_address", "agent_state",
                       "create_time", "last_heartbeat_ns"],
    "GetTables": ["table_name", "table_desc"],
    "GetSchemas": ["table_name", "column_name", "column_type", "pattern_type",
                   "column_desc"],
    "GetUDFList": ["name", "return_type", "args"],
}
#: the ctx filter of MD_SCRIPT (pods only) grouped by status alone: the
#: agents' states share one layout, so M1 merges them
MD_STATUS_SCRIPT = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status != 404]
df = df[df.ctx['namespace'] != '']
df = df.groupby('resp_status').agg(
    cnt=('latency', px.count), total=('latency', px.sum),
    avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""
MD_SEQ_SCRIPT = """
import px
df = px.DataFrame(table='seq0')
df = df.groupby('xmod10').agg(cnt=('x', px.count), s=('x', px.sum))
px.display(df, 'output')
"""
MD_STACK_SCRIPT = """
import px
df = px.DataFrame(table='stack_traces.beta')
df = df.groupby('stack_trace').agg(cnt=('count', px.sum))
px.display(df, 'output')
"""


def md_upid(u: int, UInt128):
    """UPID u: bound ones (u < 1,024) to pod u // 4 on node pod % 4 (asid
    node + 1); unbound ones on node u % 4."""
    node = (u // 4) % MD_NODES if u < MD_BOUND else u % MD_NODES
    return UInt128.make_upid(node + 1, 1000 + u, (1 << 60) + u)


def md_updates(UInt128) -> list[dict]:
    """The first snapshot: pod p of service p // 16 on node p % 4, service
    s in namespace s % 4; UPIDs as md_upid."""
    ups = []
    for p in range(MD_PODS):
        ups.append({"kind": "pod", "uid": f"pod-{p}", "name": f"web-{p}",
                    "namespace": f"ns-{(p // 16) % 4}", "node": f"node-{p % MD_NODES}",
                    "ip": f"10.0.{p // 16}.{p % 16 + 1}", "phase": "Running"})
    for s in range(N_SERVICES):
        ups.append({"kind": "service", "uid": f"svc-uid-{s}", "name": f"svc-{s}",
                    "namespace": f"ns-{s % 4}", "cluster_ip": f"10.96.0.{s + 1}",
                    "pod_uids": [f"pod-{p}" for p in range(16 * s, 16 * s + 16)]})
    for u in range(MD_UPIDS):
        d = {"kind": "process", "upid": md_upid(u, UInt128), "cmdline": f"/bin/app-{u}"}
        if u < MD_BOUND:
            d["pod_uid"] = f"pod-{u // 4}"
        ups.append(d)
    return ups


def md_epoch_updates(UInt128) -> list[dict]:
    """The epoch change: pods 0-31 (services 0 and 1) recreated as pods of
    service 15 (new pod uids, their 128 UPIDs rebound), service 5
    renamed."""
    ups = []
    for p in range(MD_MOVED_PODS):
        ups.append({"kind": "pod", "uid": f"moved-{p}", "name": f"moved-{p}",
                    "namespace": "ns-3", "node": f"node-{p % MD_NODES}",
                    "ip": f"10.1.0.{p + 1}", "phase": "Running"})
        for u in range(4 * p, 4 * p + 4):
            ups.append({"kind": "process", "upid": md_upid(u, UInt128),
                        "pod_uid": f"moved-{p}"})
    ups.append({"kind": "service", "uid": "svc-uid-15", "name": "svc-15",
                "namespace": "ns-3", "cluster_ip": "10.96.0.16",
                "pod_uids": [f"moved-{p}" for p in range(MD_MOVED_PODS)]})
    ups.append({"kind": "service", "uid": f"svc-uid-{MD_RENAMED}",
                "name": f"svc-{MD_RENAMED}-renamed", "namespace": f"ns-{MD_RENAMED % 4}",
                "cluster_ip": f"10.96.0.{MD_RENAMED + 1}"})
    return ups


def md_service_of(u: int, moved: bool) -> str:
    """The oracle's own answer to ctx['service'] for UPID u (no port code)."""
    if u >= MD_BOUND:
        return ""
    p = u // 4
    s = 15 if moved and p < MD_MOVED_PODS else p // 16
    name = f"svc-{s}-renamed" if moved and s == MD_RENAMED else f"svc-{s}"
    return f"ns-{s % 4}/{name}"


class MdHttpRows:
    """The phase's http_events rows (seed 22, or 22 + agent): upid uniform
    over `upids` (UPID indexes), given to the table as a list of UInt128
    (as the connectors push them); resp_status 200/404/500 at
    .85/.05/.10; latency int64 ns, exponential with mean 50 ms (config #1's
    draw); the unread string columns from vocabularies of at most 16
    values, drawn once for a chunk's rows and repeated in every chunk (the
    build's time goes to encoding, not drawing)."""

    VOCAB = {
        "remote_addr": np.array([f"10.2.0.{i}" for i in range(16)]),
        "req_headers": np.array(['{"Host": "svc"}', '{"Accept": "*/*"}']),
        "req_method": np.array(["GET", "POST", "PUT", "DELETE"]),
        "req_path": np.array([f"/api/v1/items/{i}" for i in range(16)]),
        "req_body": np.array(["", '{"q": 1}']),
        "resp_headers": np.array(['{"Content-Type": "application/json"}']),
        "resp_message": np.array(["OK", "Not Found", "Internal Server Error"]),
        "resp_body": np.array(["", '{"ok": true}', '{"error": "x"}']),
    }

    def __init__(self, UInt128, upids=None, seed: int = 22, rows: int = ROWS):
        self.upids = np.arange(MD_UPIDS) if upids is None else np.asarray(upids)
        self.pool = np.empty(MD_UPIDS, dtype=object)
        self.pool[:] = [md_upid(u, UInt128) for u in range(MD_UPIDS)]
        self.rng = np.random.default_rng(seed)
        self.t_step = 600 * SEC // max(rows, 1)
        self.written = 0
        draw = np.random.default_rng(seed + 1000)
        self.strings = {name: vocab[draw.integers(0, len(vocab), MD_CHUNK)]
                        for name, vocab in self.VOCAB.items()}

    def chunk(self, n: int) -> dict:
        rng = self.rng
        u = self.upids[rng.integers(0, len(self.upids), n)]
        out = {"time_": np.arange(self.written, self.written + n, dtype=np.int64) * self.t_step,
               "upid": self.pool[u].tolist(),
               "remote_port": rng.integers(1024, 65536, n),
               "trace_role": np.full(n, 2, dtype=np.int64),
               "major_version": np.ones(n, dtype=np.int64),
               "minor_version": np.ones(n, dtype=np.int64),
               "content_type": rng.integers(0, 3, n),
               "req_body_size": rng.integers(0, 4096, n),
               "resp_status": rng.choice(np.array([200, 404, 500]), n, p=[0.85, 0.05, 0.10]),
               "resp_body_size": rng.integers(0, 65536, n),
               "latency": (rng.exponential(50.0, n) * 1e6).astype(np.int64)}
        for name, col in self.strings.items():
            out[name] = col[:n] if n <= len(col) else col[np.arange(n) % len(col)]
        self.written += n
        return out

    def write(self, table, rows: int) -> None:
        end = self.written + rows
        while self.written < end:
            table.write(self.chunk(min(MD_CHUNK, end - self.written)))


def md_table(ts, rows: int, **kw):
    """An http_events table of the canonical relation in `ts`, written by
    MdHttpRows; → (table, the host seconds the build took)."""
    from pixie_tpu_torch.collect.schemas import SCHEMAS
    from pixie_tpu_torch.types import UInt128

    t0 = time.perf_counter()
    table = ts.create("http_events", SCHEMAS["http_events"], batch_rows=1 << 16,
                      max_bytes=1 << 36)
    MdHttpRows(UInt128, rows=rows, **kw).write(table, rows)
    return table, time.perf_counter() - t0


class MdOracle:
    """numpy over the tables' rows, per (UPID, status) once: counts, int64
    sums and the sketch's bin counts; each snapshot's answer folds the
    UPIDs into their services (md_service_of)."""

    def __init__(self, tables):
        W = WIDTH
        statuses = np.array([200, 500])
        self.cnt = np.zeros((MD_UPIDS, 2), np.int64)
        self.total = np.zeros((MD_UPIDS, 2), np.int64)
        self.hist = np.zeros((MD_UPIDS, 2, W), np.int64)
        from pixie_tpu_torch.types import UInt128

        index = {(v.high, v.low): u for u, v in enumerate(
            md_upid(u, UInt128) for u in range(MD_UPIDS))}
        for table in tables:
            d = table.dictionaries["upid"]
            # code → UPID index, from the dictionary's values
            code_u = np.array([index[(v.high, v.low)] for v in d.decode(np.arange(d.size))],
                              dtype=np.int64)
            for rb, _rid, _gen in table.cursor():
                n = rb.num_valid
                st = rb.columns["resp_status"][:n]
                keep = st != 404
                u = code_u[rb.columns["upid"][:n][keep]]
                s = np.searchsorted(statuses, st[keep])
                lat = rb.columns["latency"][:n][keep]
                key = u * 2 + s
                self.cnt += np.bincount(key, minlength=MD_UPIDS * 2).reshape(MD_UPIDS, 2)
                # int64 sums, exact: a batch's float64 sums stay below 2^53
                self.total += np.rint(np.bincount(key, weights=lat, minlength=MD_UPIDS * 2)
                                      ).astype(np.int64).reshape(MD_UPIDS, 2)
                x = np.maximum(lat.astype(np.float32), np.float32(MIN_VALUE))
                lg = np.log(x) / np.float32(math.log(GAMMA))
                bins = np.clip(np.ceil(lg).astype(np.int64) + 1, 0, W - 1)
                bins[lat <= MIN_VALUE] = 0
                self.hist += np.bincount(key * W + bins, minlength=MD_UPIDS * 2 * W
                                         ).reshape(MD_UPIDS, 2, W)
        self.statuses = statuses

    def check(self, label: str, res, moved: bool, by_service: bool = True) -> dict:
        """The result against this snapshot's answer: keys, counts and int64
        sums exactly, means to rtol 1e-12, p50 in the oracle's sketch bin or
        the next (ROADMAP's gates).  by_service False: MD_STATUS_SCRIPT's
        answer (the UPIDs with a pod, one group a status)."""
        if by_service:
            of = [md_service_of(u, moved) for u in range(MD_UPIDS)]
        else:
            of = ["" if u < MD_BOUND else None for u in range(MD_UPIDS)]
        keep = np.array([x is not None for x in of])
        names = sorted({x for x in of if x is not None})
        svc = np.array([names.index(x) for x in of if x is not None])
        G = len(names)
        cnt = np.zeros((G, 2), np.int64)
        total = np.zeros((G, 2), np.int64)
        hist = np.zeros((G, 2, WIDTH), np.int64)
        np.add.at(cnt, svc, self.cnt[keep])
        np.add.at(total, svc, self.total[keep])
        np.add.at(hist, svc, self.hist[keep])
        want = {}
        for g in range(G):
            for j, st in enumerate(self.statuses):
                if cnt[g, j]:
                    cum = np.cumsum(hist[g, j])
                    idx = min(int((cum < 0.5 * cum[-1]).sum()), WIDTH - 1)
                    want[(names[g], int(st))] = (int(cnt[g, j]), int(total[g, j]),
                                                 total[g, j] / cnt[g, j],
                                                 0.0 if idx <= 0 else GAMMA ** (idx - 1.5))
        df = res.to_pandas()
        got = {(getattr(r, "service", ""), int(r.resp_status)): (
                   int(r.cnt), int(r.total), float(r.avg_lat), float(r.p50))
               for r in df.itertuples(index=False)}
        if sorted(got) != sorted(want):
            raise AssertionError(f"{label}: groups {sorted(got)[:6]}... against the oracle's "
                                 f"{sorted(want)[:6]}...")
        exact = 0
        for k, (c, t, m, p) in want.items():
            gc, gt, gm, gp = got[k]
            if (gc, gt) != (c, t):
                raise AssertionError(f"{label}: {k} count / sum {gc}, {gt} against {c}, {t}")
            if not math.isclose(gm, m, rel_tol=1e-12, abs_tol=0):
                raise AssertionError(f"{label}: {k} mean {gm} against {m}")
            r = gp / p
            if not any(math.isclose(r, x, rel_tol=1e-12) for x in (1.0, GAMMA, 1 / GAMMA)):
                raise AssertionError(f"{label}: {k} p50 {gp} outside the oracle's bin {p}")
            exact += r == 1.0
        return {"groups": len(want), "rows_kept": int(cnt.sum()), "p50_exact_bin": exact,
                "services": sorted({k[0] for k in want})}


def md_executable_frame(sym) -> tuple[int, str]:
    """A runtime address inside sys.executable's executable mapping and the
    function symbol it lies in (from the ELF file: its dynamic or full
    symbol table), found by undoing NativeSymbolizer's mapping bias."""
    from pixie_tpu_torch.obj_tools import ElfReader

    exe = os.path.realpath(sys.executable)
    for lo, hi, off, path in sym.maps:
        if os.path.realpath(path) != exe:
            continue
        rd = ElfReader(path)
        base = rd.min_load_vaddr() + off if rd.e_type == 3 else lo
        for s in rd.symbols():
            if s.is_func and s.size and base <= s.addr < base + (hi - lo):
                return s.addr - base + lo, s.name
    raise AssertionError(f"metadata_collect: no function symbol of {exe} in an "
                         "executable mapping")


def md_agg_setup(query):
    """The executor's own aggregate setup (`PlanExecutor._agg_setup`: its
    chain kernel, with the agg step it made, and its group keys) from one
    run of `query`."""
    from pixie_tpu_torch.engine.executor import PlanExecutor

    got, orig = [], PlanExecutor._agg_setup

    def hook(self, op):
        got.append(orig(self, op))
        return got[-1]

    PlanExecutor._agg_setup = hook
    try:
        query()
    finally:
        PlanExecutor._agg_setup = orig
    if len(got) != 1:
        raise AssertionError(f"metadata chain: {len(got)} aggregate setups in one query")
    return got[0]


def md_chain_check(dev, table, setup) -> dict:
    """C1 on the metadata chain, as the ctx query's executor lowered it
    (`setup`: a LUT opcode over the UPID dictionary's codes, the service
    LUT's codes as a dict key), against its plain interpreter at the
    table's first 16M-row feed, then timed: → its kernel row."""
    import torch

    from pixie_tpu_torch.ops import chain as c1

    kern = setup.kern
    keys = [(k.name, k.kind) for k in setup.keys]
    if setup.op.groups != ["service", "resp_status"] or keys[0] != ("service", "dict"):
        raise AssertionError(f"metadata chain: the plan groups by {setup.op.groups}, "
                             f"keys {keys}")
    svc = kern.ctx.sym["service"]
    names = sorted({n for seg in kern.segments for n in seg.binding.cols
                    if not n.startswith("__")})
    host = {k: [] for k in names}
    got_rows = 0
    for rb, _rid, _gen in table.cursor():
        for k in names:
            host[k].append(rb.columns[k][: rb.num_valid])
        got_rows += rb.num_valid
        if got_rows >= FEED:
            break
    cols = {k: torch.from_numpy(np.concatenate(v)[:FEED]).to(dev) for k, v in host.items()}
    luts = {k: torch.as_tensor(v).to(dev) for k, v in kern.luts.items()}
    codes = [c1.OPS[op] for seg in kern.segments for op, *_ in seg.prog.code]
    if not any(name.startswith("LUT") for name in codes):
        raise AssertionError(f"metadata chain: no LUT opcode in {codes}")

    def run(runner, n_valid=FEED):
        return kern.run_segments(kern.segments, cols, FEED, n_valid, -(2 ** 63), 2 ** 63 - 1,
                                 None, luts, setup.origins, runner=runner)

    for case, n_valid in (("", FEED), (", n_valid < n", FEED - 12345)):
        got, want = run(c1.run, n_valid), run(c1.run_plain, n_valid)
        torch.cuda.synchronize()
        c1_compare("metadata chain" + case + " mask", got[0], want[0])
        c1_compare("metadata chain" + case + " gid", got[1], want[1])
        for j, (g, w) in enumerate(zip(got[2], want[2])):
            c1_compare(f"metadata chain{case} output {j}", g, w)
        log(json.dumps({"check": "C1 metadata chain" + case, "ok": True,
                        "kept": int(got[0].sum()), "programs": len(kern.segments),
                        "opcodes": codes, "keys": keys}))
    b_ms, b_by = chain_bound(kern, FEED)
    return {
        "name": "chain C1 (metadata chain: LUT over UPID codes)", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/chain.cu",
        "replaces": "pixie_tpu/engine/executor.py:566-765 ChainKernel; eval.py:57 apply_lut "
                    "(metadata UDFs as LUTs, metadata/funcs.py)",
        "entry": C1, "path": "metadata_collect", "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: run(c1.run), 20),
        "plain_ms": cuda_ms(lambda: run(c1.run_plain), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a chain program
        "library_ms": None,
        "shape": {"rows": FEED, "programs": len(kern.segments),
                  "upids": table.dictionaries["upid"].size, "services": svc.dictionary.size,
                  "instructions": [len(s.prog.code) for s in kern.segments],
                  "device_ms": kernel_device_ms(lambda: run(c1.run), 10),
                  "host_us": host_us(lambda: run(c1.run), 100)},
    }


def md_lut_ms(table) -> float:
    """Host ms to evaluate the ctx query's two LUTs over the UPID
    dictionary (upid_to_service_name, upid_to_namespace), as eval.py's host
    call does: each function over every dictionary value into a string
    dictionary's codes."""
    from pixie_tpu_torch.table.dictionary import Dictionary
    from pixie_tpu_torch.types import DataType as DT
    from pixie_tpu_torch.udf import registry

    d = table.dictionaries["upid"]
    t0 = time.perf_counter()
    for name in ("upid_to_service_name", "upid_to_namespace"):
        fn = registry.scalar(name, (DT.UINT128,)).fn
        out = Dictionary()
        d.lut(lambda v, fn=fn, out=out: out.code(fn(v)), np.int32)
    return (time.perf_counter() - t0) * 1e3


def md_query(q, ts, dev):
    """→ query() for stream_and_warm: one execute_plan of the ctx plan."""
    import torch

    from pixie_tpu_torch.engine import execute_plan

    def query():
        r = execute_plan(q.plan, ts, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    return query


def md_single(dev, smi: str) -> dict:
    """The 64M-row table, the ctx query (its launches, the oracle, stream
    and warm medians, the host LUT time), C1's check on its chain, then the
    epoch change (its warm query's wall, H2D bytes and LUT uploads)."""
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine.executor import device_cache_stats
    from pixie_tpu_torch.metadata import state as md_state
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import UInt128

    ts = TableStore()
    table, build_s = md_table(ts, ROWS)
    log(json.dumps({"phase": "metadata_collect.data", "rows": ROWS, "card": smi,
                    "build_s": build_s, "upids": table.dictionaries["upid"].size,
                    "columns": len(table.relation.names())}))
    t0 = time.perf_counter()
    oracle = MdOracle([table])
    oracle_s = time.perf_counter() - t0
    q = compile_pxl(MD_SCRIPT, ts.schemas())
    query = md_query(q, ts, dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    first = query()
    first_s = time.perf_counter() - t0
    launches = read_launches("metadata_collect", MD_KERNELS)
    held = oracle.check("metadata_collect ctx query", first, moved=False)
    check_leaves("metadata_collect", first.exec_stats)
    timing = stream_and_warm(query, "metadata_collect ctx query")
    lut_ms = sorted(md_lut_ms(table) for _ in range(5))[2]
    row = md_chain_check(dev, table, md_agg_setup(query))
    a = {"card": smi, "rows": ROWS, "first_s": first_s, **held, "oracle_s": oracle_s,
         "lut_host_ms": lut_ms, **{k: v for k, v in timing.items() if k != "settle_h2d_bytes"},
         "launches": {lib: {e: n for e, n in by.items() if n}
                      for lib, by in launches.items() if any(by.values())}}
    log(json.dumps({"phase": "metadata_collect.ctx", "ok": True, **a}))

    # the epoch change: the next warm query must group by the new snapshot;
    # only the changed LUT travels (the columns stay resident)
    mgr = md_state.global_manager()
    epoch = mgr.epoch
    t0 = time.perf_counter()
    mgr.apply_updates(md_epoch_updates(UInt128))
    apply_ms = (time.perf_counter() - t0) * 1e3
    before = device_cache_stats()
    t0 = time.perf_counter()
    after = query()
    wall = time.perf_counter() - t0
    mid = device_cache_stats()
    held2 = oracle.check("metadata_collect after the epoch change", after, moved=True)
    again = warm_times(query, warmup=0, reps=5)
    end = device_cache_stats()
    e = {"card": smi, "epoch": [epoch, mgr.epoch], "apply_ms": apply_ms, "wall_s": wall,
         "h2d_bytes": after.exec_stats["h2d_bytes"],
         "lut_uploads": mid["lut_uploads"] - before["lut_uploads"],
         "lut_h2d_bytes": mid["lut_upload_bytes"] - before["lut_upload_bytes"],
         "lut_uploads_next_5": end["lut_uploads"] - mid["lut_uploads"],
         "warm_median_s_after": again[2], **held2}
    if e["h2d_bytes"] or not e["lut_uploads"] or e["lut_uploads_next_5"]:
        raise AssertionError(f"metadata_collect: the epoch change's query moved {e}")
    log(json.dumps({"phase": "metadata_collect.epoch", "ok": True, **e}))
    return {"launches": launches, "row": row, "ctx": a, "epoch": e}


def md_cluster(dev, smi: str) -> dict:
    """The ctx query through a 4-agent LocalCluster (an agent a node, 2^22
    rows each of its own UPIDs, in the order they arrive): each agent's
    service dictionary follows its own UPID order, so the states merge on
    the host by key values (M1 launched no time; each agent's state read
    back through P1); the same filter grouped by status alone merges on M1
    once; the oracle holds both.  Then the UDTFs and px.asid() /
    px.node_name() through it."""
    import torch

    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.table import TableStore

    stores, tables, build_s = {}, [], 0.0
    for a in range(MD_NODES):
        bound = [u for u in range(MD_BOUND) if (u // 4) % MD_NODES == a]
        unbound = [u for u in range(MD_BOUND, MD_UPIDS) if u % MD_NODES == a]
        ts = TableStore()
        t, s = md_table(ts, MD_AGENT_ROWS, upids=bound + unbound, seed=22 + a)
        stores[f"pem{a}"], build_s = ts, build_s + s
        tables.append(t)
    oracle = MdOracle(tables)
    cluster = LocalCluster(stores, device=dev)
    launched = {}

    def query(script, m1_want, p1_want):
        def run():
            m1, p1 = (_build.KERNELS[lib].by_entry.get(e, 0) for lib, e in (M1, P1))
            r = cluster.query(script)["output"]
            torch.cuda.synchronize(dev)
            got = tuple(_build.KERNELS[lib].by_entry.get(e, 0) - n
                        for (lib, e), n in ((M1, m1), (P1, p1)))
            if got != (m1_want, p1_want):
                raise AssertionError(f"metadata_collect cluster: M1, P1 launched {got} "
                                     f"times, want {(m1_want, p1_want)}")
            launched[script] = {"M1": got[0], "P1": got[1]}
            return r

        return run

    from pixie_tpu_torch.metadata import state as md_state

    moved = md_state.global_manager().epoch > 1
    by_service = query(MD_SCRIPT, 0, MD_NODES)
    held = oracle.check("metadata_collect cluster", by_service(), moved=moved)
    times = warm_times(by_service, warmup=1, reps=5)
    by_status = query(MD_STATUS_SCRIPT, 1, 0)
    held_m1 = oracle.check("metadata_collect cluster by status", by_status(), moved=moved,
                           by_service=False)
    times_m1 = warm_times(by_status, warmup=1, reps=5)
    res = cluster.query("""
import px
px.display(px.GetAgentStatus(), 'GetAgentStatus')
px.display(px.GetTables(), 'GetTables')
px.display(px.GetSchemas(), 'GetSchemas')
px.display(px.GetUDFList(), 'GetUDFList')
df = px.DataFrame(table='http_events', select=['time_', 'upid'])
df = df.groupby('upid').agg(n=('time_', px.count))
df = df.agg(upids=('n', px.count))
df.asid = px.asid()
df.node = px.node_name()
px.display(df, 'ctx')
""")
    cols = {k: [c.name for c in res[k].relation] for k in MD_UDTF_COLUMNS}
    if cols != MD_UDTF_COLUMNS:
        raise AssertionError(f"metadata_collect: UDTF columns {cols}")
    udfs = set(res["GetUDFList"].to_pandas()["name"])
    tables_seen = res["GetTables"].to_pandas()["table_name"].tolist()
    ctx = res["ctx"].to_pandas()
    snap = md_state.snapshot()
    if (len(udfs) != 135 or "http_events" not in tables_seen
            or ctx["asid"].tolist() != [snap.asid] or ctx["node"].tolist() != [snap.node_name]
            or ctx["upids"].tolist() != [MD_UPIDS]):
        raise AssertionError(f"metadata_collect: cluster UDTFs {len(udfs)} UDFs, tables "
                             f"{tables_seen}, ctx {ctx.to_dict('records')}")
    c = {"card": smi, "agents": MD_NODES, "rows": MD_NODES * MD_AGENT_ROWS,
         "build_s": build_s, "route": "host value-keyed merge",
         "launches": launched[MD_SCRIPT], "warm_median_s": times[2], "warm_s": times, **held,
         "by_status": {"route": "M1", "launches": launched[MD_STATUS_SCRIPT],
                       "warm_median_s": times_m1[2], "warm_s": times_m1, **held_m1},
         "udtf_columns": cols, "udf_names": len(udfs),
         "agent_status": res["GetAgentStatus"].to_pandas().astype(str).to_dict("records"),
         "asid": ctx["asid"].tolist(), "node_name": ctx["node"].tolist()}
    log(json.dumps({"phase": "metadata_collect.cluster", "ok": True, **c}))
    return c


def md_collect(dev, smi: str, profiler) -> dict:
    """The collectors: seq_gen, process and network stats on the Collector's
    thread while 50 warm queries run over seq0; replay of 2^22 http_events
    rows, then the ctx query over them; the profiler's table."""
    import ctypes

    import torch

    from pixie_tpu_torch.collect import (Collector, NetworkStatsConnector,
                                         ProcessStatsConnector, ReplayConnector,
                                         SeqGenConnector)
    from pixie_tpu_torch.collect.schemas import SCHEMAS
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.metadata import state as md_state
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.types import UInt128

    # (a) ingest on the poll thread while queries run
    col = Collector()
    # at most 2^22 rows: seq0 (32 B a row) stays below its table's 256 MiB,
    # so no batch expires and every snapshot is a prefix x = 0, 1, ...
    col.register(SeqGenConnector(rows_per_transfer=1 << 15, sample_period_s=0.01,
                                 total_rows=MD_SEQ_ROWS))
    col.register(ProcessStatsConnector(sample_period_s=0.5))
    col.register(NetworkStatsConnector(sample_period_s=0.5))
    col.transfer_once()
    q = compile_pxl(MD_SEQ_SCRIPT, col.store.schemas())

    def seq_query():
        r = execute_plan(q.plan, col.store, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    seq_query()
    seq0 = col.store.table("seq0")
    totals, query_s = [], []
    rows0 = seq0.stats()["rows_written"]
    t0 = time.perf_counter()
    col.start()
    try:
        for _ in range(50):
            tq = time.perf_counter()
            df = seq_query().to_pandas()
            n = int(df["cnt"].sum())
            # a snapshot holds a prefix of x = 0, 1, ...: its sum is exact
            if int(df["s"].sum()) != n * (n - 1) // 2 or (totals and n < totals[-1]):
                raise AssertionError(f"metadata_collect: seq0 query saw {n} rows, sum "
                                     f"{int(df['s'].sum())} after {totals[-3:]}")
            totals.append(n)
            query_s.append(time.perf_counter() - tq)
        wall = time.perf_counter() - t0
        rows1 = seq0.stats()["rows_written"]
    finally:
        col.stop()
    final = seq_query().to_pandas()
    n = int(final["cnt"].sum())
    if (n != seq0.stats()["rows_written"] or int(final["s"].sum()) != n * (n - 1) // 2
            or len(set(totals)) < 3):
        raise AssertionError(f"metadata_collect: seq0 ended at {n} rows of "
                             f"{seq0.stats()['rows_written']}, queries saw {totals}")
    a = {"card": smi, "queries": len(totals), "wall_s": wall,
         "seq0_rows_per_s": (rows1 - rows0) / wall,
         "query_median_s": sorted(query_s)[len(query_s) // 2],
         "seq0_rows_seen": [totals[0], totals[-1]], "distinct_counts": len(set(totals)),
         "process_stats_rows": col.store.table("process_stats").stats()["rows_written"],
         "network_stats_rows": col.store.table("network_stats").stats()["rows_written"],
         "errors": col.stats["errors"]}
    log(json.dumps({"phase": "metadata_collect.ingest", "ok": True, **a}))

    # (b) replay recorded http_events rows, time rewritten, then the ctx query
    gen = MdHttpRows(UInt128, seed=23, rows=MD_REPLAY_ROWS)
    data = gen.chunk(MD_REPLAY_ROWS)
    rc = Collector()
    rc.register(ReplayConnector("http_events", SCHEMAS["http_events"], data=data,
                                rows_per_transfer=1 << 16))
    t0 = time.perf_counter()
    while rc.transfer_once():
        pass
    replay_s = time.perf_counter() - t0
    table = rc.store.table("http_events")
    if table.stats()["rows_written"] != MD_REPLAY_ROWS:
        raise AssertionError(f"metadata_collect: replayed {table.stats()}")
    moved = md_state.global_manager().epoch > 1
    res = md_query(compile_pxl(MD_SCRIPT, rc.store.schemas()), rc.store, dev)()
    held = MdOracle([table]).check("metadata_collect replay", res, moved=moved)
    b = {"card": smi, "rows": MD_REPLAY_ROWS, "replay_s": replay_s,
         "rows_per_s": MD_REPLAY_ROWS / replay_s, **held}
    log(json.dumps({"phase": "metadata_collect.replay", "ok": True, **b}))

    # (c) the profiler, sampling this process since the phase began; native
    # frames: the interpreter's Py_GetVersion (in sys.executable or the
    # libpython it links), and a function of sys.executable's own mapping
    pcol, prof = profiler
    addr = ctypes.cast(ctypes.pythonapi.Py_GetVersion, ctypes.c_void_p).value
    exe_addr, exe_sym = md_executable_frame(prof._symbolizer())
    prof.add_native_sample([exe_addr, addr], count=1)
    frame = prof.fold_native_stack([exe_addr, addr])
    mapping = next((p for lo, hi, _off, p in prof._symbolizer().maps if lo <= addr < hi), None)
    pcol.transfer_once()
    pcol.stop()
    stacks = pcol.store.table("stack_traces.beta")
    exe = os.path.basename(os.path.realpath(sys.executable))
    if (not stacks.stats()["rows_written"]
            or frame != f"{prof._symbolizer().symbolize(addr)};{exe_sym} ({exe})"
            or not frame.startswith("Py_GetVersion (")):
        raise AssertionError(f"metadata_collect: profiler rows {stacks.stats()}, "
                             f"native frames {frame!r} (Py_GetVersion in {mapping}, "
                             f"{exe_sym} of {exe})")
    _build.reset_launches()
    flame = execute_plan(compile_pxl(MD_STACK_SCRIPT, pcol.store.schemas()).plan, pcol.store,
                         device=dev)["output"].to_pandas()
    torch.cuda.synchronize(dev)
    flame_launches = {lib: {e: n for e, n in k.by_entry.items() if n}
                      for lib, k in _build.KERNELS.items() if k.launches}
    if int(flame["cnt"].sum()) != int(sum(rb.columns["count"][: rb.num_valid].sum()
                                          for rb, _r, _g in stacks.cursor())):
        raise AssertionError("metadata_collect: the flame query's counts differ from the table's")
    c = {"card": smi, "samples": prof.samples_taken, "stack_rows": stacks.stats()["rows_written"],
         "stacks": len(flame), "native_frame": frame, "native_mapping": mapping,
         "executable": sys.executable, "flame_launches": flame_launches}
    log(json.dumps({"phase": "metadata_collect.profiler", "ok": True, **c}))
    return {"ingest": a, "replay": b, "profiler": c}


def run_metadata_collect(dev, smi: str) -> dict:
    """Slice 22 on the card: the metadata state's snapshot installed, the
    profiler sampling throughout; the 64M-row ctx query and its epoch
    change, the cluster, the collectors."""
    from pixie_tpu_torch.collect import Collector
    from pixie_tpu_torch.collect.perf_profiler import PerfProfilerConnector
    from pixie_tpu_torch.metadata import state as md_state
    from pixie_tpu_torch.types import UInt128

    old = md_state.global_manager()
    mgr = md_state.MetadataStateManager(asid=1, node_name="node-0")
    mgr.apply_updates(md_updates(UInt128))
    md_state.set_global_manager(mgr)
    pcol = Collector()
    prof = PerfProfilerConnector(hz=99.0, push_period_s=1.0, asid=1)
    pcol.register(prof)
    pcol.start()
    try:
        single = md_single(dev, smi)
        cluster = md_cluster(dev, smi)
        collect = md_collect(dev, smi, (pcol, prof))
    finally:
        pcol.stop()
        md_state.set_global_manager(old)
    return {"launches": single["launches"], "row": single["row"], "single": single,
            "cluster": cluster, "collect": collect}


PIN_FLAGS = {"PX_AUTOTUNE": "0", "PX_CPU_CROSSOVER_ROWS": "0"}


def pinned(phase: str) -> None:
    """Log that `phase` runs pinned to the card route, from the PIN_FLAGS
    values the port reads (set before it is imported, so worker processes
    inherit them; the cpu_route phase restores them when it ends)."""
    import pixie_tpu_torch.engine.executor  # noqa: F401  (defines the flags)
    from pixie_tpu_torch import flags

    got = {"PX_AUTOTUNE": flags.get("PX_AUTOTUNE"),
           "PX_CPU_CROSSOVER_ROWS": flags.get("PX_CPU_CROSSOVER_ROWS")}
    if got != {"PX_AUTOTUNE": False, "PX_CPU_CROSSOVER_ROWS": 0}:
        raise AssertionError(f"{phase}: the card route is not pinned: {got}")
    log(json.dumps({"phase": phase, "pinned": "device", **got}))


def _launch_total() -> int:
    from pixie_tpu_torch.ops import _build

    return sum(k.launches for k in _build.KERNELS.values())


def _state_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _state_leaves(tree[k], f"{prefix}.{k}")
    else:
        yield prefix, np.asarray(tree)


def same_across_routes(cpu_state, dev_state, label: str) -> int:
    """A CPU-route state against the card route's on the same rows: integer
    leaves (counts, int64 sums, min, max) exactly, float64 leaves to rtol
    1e-12 (the card's atomics add floats in another order), each sketch
    group's total exactly with a value moved at most to the adjacent bin:
    the CPU route bins as the reference's CPU routes (f32 log times
    1/log(gamma)), the card as its device route (divided by log(gamma)),
    and the two differ for a value within an ulp of a bin edge.  → the
    number of sketch values in another bin."""
    got, want = dict(_state_leaves(cpu_state)), dict(_state_leaves(dev_state))
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: state leaves {sorted(got)} != {sorted(want)}")
    moved = 0
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: leaf {k} has another dtype or shape")
        if w.dtype == np.float32 and w.ndim == 2:  # a sketch: [groups, bins]
            step = np.abs(np.cumsum(g.astype(np.int64) - w.astype(np.int64), axis=1))
            ok = not step[:, -1].any() and step.sum() <= max(16, w.sum() * 1e-5)
            moved += int(step.sum())
        elif w.dtype == np.float64:
            ok = np.allclose(g, w, rtol=1e-12, atol=0)
        else:
            ok = np.array_equal(g, w)
        if not ok:
            raise AssertionError(f"{label}: leaf {k} differs across the routes")
    return moved


def same_results(a, b, keys, label: str, quantiles=()) -> None:
    """Two finalized results over the same rows: keys and integer columns
    exactly, float columns to rtol 1e-12, the `quantiles` columns in the
    same sketch bin or the adjacent one (ratio at most gamma)."""
    def rows(r):
        o = np.lexsort([np.asarray(r.columns[k]) for k in reversed(keys)])
        return {c: np.asarray(v)[o] for c, v in r.columns.items()}

    ra, rb = rows(a), rows(b)
    if ra.keys() != rb.keys():
        raise AssertionError(f"{label}: columns differ")
    for c, x in ra.items():
        y = rb[c]
        if x.shape != y.shape:
            ok = False
        elif c in quantiles:
            ok = bool(np.all(np.abs(np.log(x / y)) <= math.log(GAMMA) * (1 + 1e-9)))
        elif x.dtype.kind == "f":
            ok = np.allclose(x, y, rtol=1e-12, atol=0)
        else:
            ok = np.array_equal(x, y)
        if not ok:
            raise AssertionError(f"{label}: column {c} differs across the routes")


def _route_states(ts, plan, dev):
    """The aggregate's raw state on each arm: (CPU numpy state, the card's
    pulled state, the CPU executor's stats, the CPU run's launches)."""
    import torch

    from pixie_tpu_torch.engine import transfer
    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.ops import _build

    agg = next(op for op in plan.ops() if op.kind == "agg")
    cpu = PlanExecutor(plan, ts, device=dev, force_backend="cpu", mesh=None)
    _build.reset_launches()
    cpu_state = cpu._agg_state(agg)[2]
    launches = _launch_total()
    card = PlanExecutor(plan, ts, device=dev, force_backend="device", mesh=None)
    dev_state = transfer.pull_states([card._agg_state(agg)[2]])[0]
    torch.cuda.synchronize()
    return cpu_state, dev_state, cpu.stats, launches


def np_partial_plan():
    """groupby('service') → count, mean(latency), p99(latency): no filter,
    no map, so the np_partial loop owns it."""
    from pixie_tpu_torch.plan import AggExpr, AggOp, MemorySinkOp, MemorySourceOp, Plan

    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    agg = p.add(AggOp(groups=["service"], values=[
        AggExpr("cnt", "count", None), AggExpr("avg_lat", "mean", "latency"),
        AggExpr("p99", "p99", "latency")]), parents=[src])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


def run_cpu_route(dev) -> dict:
    """The CPU route (slice 19): the host fast paths against the card.

    The sweep: config #1 (http_plan, the whole-plan loop) over
    build_http_table at each CPU_ROUTE_SIZES size, each arm pinned in turn
    (force_backend), the warm median of 5 after 2 warm-ups, and the CPU
    route's cold wall (its first query on the table); every CPU-routed query
    moves 0 H2D bytes and launches no kernel, and its answer and its raw
    state agree with the card route's.  The default crossover is the largest
    size at which the CPU route's warm median beats the card's (0 if none).
    With PX_AUTOTUNE off and the crossover at that default, the unpinned run
    of each size must take the arm the default says.  Then the np_partial
    query at 2^20 rows, config #4's 8 stores of 2^18 rows through
    LocalCluster (routed by their 2,097,152 rows, not one store's), the
    native host join against J1-J3 at 2^16 rows a side (equal pair sets),
    and the autotune harness with the static arm's crossover mis-set."""
    import torch

    from pixie_tpu_torch import flags
    from pixie_tpu_torch.engine import autotune_bench
    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.native import build as native_build
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.ops import join_device as jd
    from pixie_tpu_torch.parallel.cluster import LocalCluster
    from pixie_tpu_torch.table import TableStore

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if native_build.load_native() is None:
        raise AssertionError(f"native library: {native_build.build_error()}")
    log(json.dumps({"phase": "cpu_route.native_build", "wall_s": time.perf_counter() - t0,
                    "g++_s": native_build.build_seconds,
                    "library": native_build.library_path().name}))
    # the port's own defaults (the smoke's pins set both through the env)
    defaults = flags.dump()
    compiled_default = int(defaults["PX_CPU_CROSSOVER_ROWS"]["default"])
    autotune_default = bool(defaults["PX_AUTOTUNE"]["default"])
    flags.set_for_testing("PX_AUTOTUNE", False)
    plan = http_plan()

    def run(ts, arm):
        ex = PlanExecutor(plan, ts, device=dev, force_backend=arm, mesh=None)
        res = ex.run()["output"]
        torch.cuda.synchronize()
        return ex, res

    sweep, tables = [], {}
    for rows in CPU_ROUTE_SIZES:
        ts = TableStore()
        build_http_table(ts, rows)
        tables[rows] = ts
        _build.reset_launches()
        t0 = time.perf_counter()
        ex, cpu_res = run(ts, "cpu")
        cold_ms = (time.perf_counter() - t0) * 1e3
        if ex.stats.get("wholeplan_native") != 1 or ex.stats["h2d_bytes"] != 0 \
                or _launch_total() != 0:
            raise AssertionError(f"cpu_route {rows}: the CPU route ran {ex.stats}")
        cpu_ms = float(np.median(warm_times(lambda: run(ts, "cpu")))) * 1e3
        _ex, dev_res = run(ts, "device")
        dev_ms = float(np.median(warm_times(lambda: run(ts, "device")))) * 1e3
        same_results(cpu_res, dev_res, ["service", "status"], f"cpu_route {rows}",
                     quantiles=("p50",))
        row = {"rows": rows, "cpu_warm_ms": cpu_ms, "device_warm_ms": dev_ms,
               "cpu_cold_ms": cold_ms, "cpu_wins": cpu_ms < dev_ms}
        sweep.append(row)
        log(json.dumps({"phase": "cpu_route.sweep", **row}))
    default = max((r["rows"] for r in sweep if r["cpu_wins"]), default=0)
    log(json.dumps({"phase": "cpu_route.default", "crossover_rows": default,
                    "flag_default": compiled_default,
                    "flag_matches_sweep": default == compiled_default}))

    # raw states across the routes at the sweep's 2^20 rows: bins and
    # integers exactly
    cpu_state, dev_state, _st, launches = _route_states(tables[NP_PARTIAL_ROWS], plan, dev)
    if launches:
        raise AssertionError(f"cpu_route: the CPU state launched {launches} kernels")
    moved = same_across_routes(cpu_state, dev_state, "cpu_route config #1 state")
    log(json.dumps({"phase": "cpu_route.states", "rows": NP_PARTIAL_ROWS,
                    "sketch_values_in_the_adjacent_bin": moved}))

    # routing: the unpinned run of each size takes the arm the default says
    flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", default)
    routed = {}
    for rows, ts in tables.items():
        ex = PlanExecutor(plan, ts, device=dev, mesh=None)
        ex.run()
        arm = ex.stats["routes"][0]["arm"]
        want = "cpu" if rows <= default else "device"
        if arm != want:
            raise AssertionError(f"cpu_route: {rows} rows routed to {arm}, want {want}")
        routed[rows] = arm
    log(json.dumps({"phase": "cpu_route.routing", "crossover_rows": default, "arms": routed}))

    # the default config, unpinned, under autotune at its default against the
    # pinned card route: p50 and p99 of 100 warm queries, at 2^20 and 2^24
    flags.set_for_testing("PX_AUTOTUNE", autotune_default)
    for rows in (1 << 20, 1 << 24):
        ts = tables[rows]
        pct = {}
        decisions = []
        for arm in ("device", None, "device", None):
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                ex, _res = run(ts, arm)
                times.append(time.perf_counter() - t0)
                if arm is None:
                    decisions += [d for d in ex.stats.get("autotune", [])
                                  if d["gate"] == "cpu_crossover"]
                    if default == 0 and ex.stats["routes"][0]["arm"] != "device":
                        raise AssertionError(f"cpu_route: unpinned {rows} rows left the card")
            pct.setdefault(arm or "unpinned", []).extend(times)
        if default == 0 and decisions:
            raise AssertionError(f"cpu_route: {len(decisions)} cpu_crossover decisions "
                                 "at crossover 0")
        log(json.dumps({"phase": "cpu_route.default_path", "rows": rows,
                        "autotune": autotune_default, "crossover_rows": default,
                        "queries_each": len(pct["unpinned"]),
                        "cpu_crossover_decisions": len(decisions),
                        **{f"{k}_{q}_ms": float(np.percentile(v, p)) * 1e3
                           for k, v in pct.items() for q, p in (("p50", 50), ("p99", 99))}}))
    flags.set_for_testing("PX_AUTOTUNE", False)
    del tables

    # the np_partial loop at 2^20 rows
    ts = TableStore()
    build_http_table(ts, NP_PARTIAL_ROWS)
    npp = np_partial_plan()
    cpu_state, dev_state, st, launches = _route_states(ts, npp, dev)
    if st.get("np_fast_polls") != 1 or st["h2d_bytes"] != 0 or launches:
        raise AssertionError(f"cpu_route np_partial: {st}, {launches} launches")
    moved = same_across_routes(cpu_state, dev_state, "cpu_route np_partial state")
    outs = {}
    for arm in ("cpu", "device"):
        ex = PlanExecutor(npp, ts, device=dev, force_backend=arm, mesh=None)
        outs[arm] = ex.run()["output"]
        if arm == "cpu":
            np_ms = float(np.median(warm_times(lambda: PlanExecutor(
                npp, ts, device=dev, force_backend="cpu", mesh=None).run()))) * 1e3
    same_results(outs["cpu"], outs["device"], ["service"], "cpu_route np_partial",
                 quantiles=("p99",))
    log(json.dumps({"phase": "cpu_route.np_partial", "rows": NP_PARTIAL_ROWS,
                    "np_fast_polls": st["np_fast_polls"], "h2d_bytes": st["h2d_bytes"],
                    "launches": launches, "cpu_warm_ms": np_ms,
                    "sketch_values_in_the_adjacent_bin": moved}))
    del ts

    # the cluster: 8 stores of 2^18 rows route by the query's 2^21 rows, at
    # the sweep's crossover and at one between a store's rows and the query's
    stores, _tables = _agent_stores(CLUSTER_ROUTE_ROWS)
    flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0)
    card = LocalCluster(stores, device=dev).query(CONFIG4_SCRIPT)["output"]
    query_rows = CLUSTER_ROUTE_ROWS * CONFIG4_AGENTS
    for crossover in (default, 2 * CLUSTER_ROUTE_ROWS):
        flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", crossover)
        cluster = LocalCluster(stores, device=dev)
        want = "cpu" if query_rows <= crossover else "device"
        one_store = "cpu" if CLUSTER_ROUTE_ROWS <= crossover else "device"
        _build.reset_launches()
        res = cluster.query(CONFIG4_SCRIPT)["output"]
        torch.cuda.synchronize()
        launches = _launch_total()
        arms = {r["arm"] for s in res.exec_stats["agents"].values() for r in s["routes"]}
        h2d = res.exec_stats["transfer"]["h2d_bytes"]
        if arms != {want} or (want == "cpu" and (h2d or launches)):
            raise AssertionError(f"cpu_route cluster: arms {arms} (want {want}), h2d {h2d}, "
                                 f"{launches} launches")
        same_results(res, card, ["service", "status"], "cpu_route cluster", quantiles=("p50",))
        log(json.dumps({"phase": "cpu_route.cluster", "agents": CONFIG4_AGENTS,
                        "rows_each": CLUSTER_ROUTE_ROWS, "query_rows": query_rows,
                        "crossover_rows": crossover, "decision": want,
                        "one_store_alone_would_route": one_store, "h2d_bytes": h2d,
                        "launches": launches}))
    flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", default)
    del stores, cluster

    # the native host join against J1-J3
    rng = np.random.default_rng(19)
    b = rng.integers(0, NATIVE_JOIN_ROWS // 4, NATIVE_JOIN_ROWS).astype(np.int64)
    p = rng.integers(0, NATIVE_JOIN_ROWS // 4, NATIVE_JOIN_ROWS).astype(np.int64)
    nat = jd.native_join_codes(b, p)
    dj = jd.device_join_codes(b, p, device=dev)

    def pairs(out):
        o = np.lexsort((out[1], out[0]))
        return out[0][o], out[1][o]

    (nb_, np_), (db_, dp_) = pairs(nat), pairs(dj)
    if not (np.array_equal(nb_, db_) and np.array_equal(np_, dp_)
            and np.array_equal(nat[2], dj[2]) and np.array_equal(nat[3], dj[3])):
        raise AssertionError("cpu_route: the native join's pairs differ from J1-J3's")
    t0 = time.perf_counter()
    for _ in range(5):
        jd.native_join_codes(b, p)
    nat_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        jd.device_join_codes(b, p, device=dev)
    dj_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(json.dumps({"phase": "cpu_route.native_join", "rows_a_side": NATIVE_JOIN_ROWS,
                    "pairs": int(len(nb_)), "pair_sets_equal": True,
                    "native_ms": nat_ms, "j1_j3_ms": dj_ms}))

    # the autotune harness: the static arm's crossover set to the wrong arm
    bench_rows = 400_000
    mis_set = 4096 if bench_rows <= default else 1 << 40
    at = autotune_bench.run_adaptive_gates(rows=bench_rows, device=dev, mis_set=mis_set)
    if at["tolerance_equal_frac"] != 1.0:
        raise AssertionError(f"cpu_route autotune: answers differ across arms: {at}")
    log(json.dumps({"phase": "cpu_route.autotune", "comparison": "tolerance (ints exact, "
                    "floats rtol 1e-12), not bits", **at}))
    for f, v in PIN_FLAGS.items():
        flags.set_for_testing(f, v)
    log(json.dumps({"phase": "cpu_route", "seconds": time.perf_counter() - t_phase}))
    return {"sweep": sweep, "default": default}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm query with torch.profiler")
    ap.add_argument("--only-cpu-route", action="store_true",
                    help="build the kernels and run the cpu_route phase alone "
                         "(no contract lines: not the smoke)")
    ap.add_argument("--only-host-layers", action="store_true",
                    help="build the kernels and run the host_layers phase alone "
                         "(no contract lines: not the smoke)")
    ap.add_argument("--only-metadata-collect", action="store_true",
                    help="build the kernels and run the metadata_collect phase alone "
                         "(no contract lines: not the smoke)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # every phase before cpu_route pins the card route: set before the port
    # reads its flags, so worker processes inherit them
    os.environ.update(PIN_FLAGS)
    import pixie_tpu_torch  # noqa: F401  (fails outside the repo)
    import pixie_tpu_torch.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.ops import _build

    # every phase but the matview phase measures the rescan route
    flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(json.dumps({"phase": "device", "name": name, "nvidia_smi": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(json.dumps({"phase": "build", "wall_s": time.perf_counter() - t0,
                    "nvcc_s": secs}))

    if args.only_cpu_route:
        run_cpu_route(dev)
        log("only the cpu_route phase ran: this is not the smoke's result")
        return 0
    if args.only_host_layers:
        pinned("host_layers")
        run_host_layers(dev, smi)
        log("only the host_layers phase ran: this is not the smoke's result")
        return 0
    if args.only_metadata_collect:
        pinned("metadata_collect")
        run_metadata_collect(dev, smi)
        log("only the metadata_collect phase ran: this is not the smoke's result")
        return 0
    pinned("kernels")
    rows = (check_kernels(dev) + check_new_kernels(dev) + check_resident_kernels(dev)
            + check_merge_kernel(dev) + check_kmeans_kernels(dev) + check_chain_kernel(dev)
            + check_repartition_kernels(dev) + check_collective_merge(dev))
    pinned("slice")
    sl, ts, table = run_slice(dev, args.profile)
    log(json.dumps({"phase": "slice", "card": smi, **sl}))
    paths = {"config1": sl["launches"]}
    t0 = time.perf_counter()
    pinned("union")
    paths["union"] = run_union(dev, ts, table)["launches"]
    log(json.dumps({"phase": "union", "card": smi, "seconds": time.perf_counter() - t0}))
    pinned("select")
    paths["select"] = run_select(dev, ts, table, args.profile)["select"]["launches"]
    pinned("config2")
    paths["config2"] = run_config2(dev, ts, table)["launches"]
    pinned("gang_checks")
    rows += check_gang_kernel(dev, ts)
    t0 = time.perf_counter()
    pinned("finalize_checks")
    rows += check_finalize_kernels(dev, ts)
    log(json.dumps({"phase": "finalize_checks", "card": smi,
                    "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    pinned("batch")
    batch = run_batch(dev, ts, table)
    log(json.dumps({"phase": "batch", "card": smi, "seconds": time.perf_counter() - t0,
                    **{k: v for k, v in batch.items() if k != "launches"}}))
    paths["batch"] = batch["launches"]
    t0 = time.perf_counter()
    pinned("mesh_config1")
    paths["mesh_config1"] = run_mesh_config1(dev, ts, table)["launches"]
    log(json.dumps({"phase": "mesh_config1", "card": smi,
                    "seconds": time.perf_counter() - t0}))
    del ts, table
    t0 = time.perf_counter()
    pinned("config1_one_feed")
    paths["config1_one_feed"] = run_config1_one_feed(dev)["launches"]
    log(json.dumps({"phase": "config1_one_feed", "card": smi,
                    "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    pinned("mesh_cluster")
    paths["mesh_cluster"] = run_mesh_cluster(dev)["launches"]
    log(json.dumps({"phase": "mesh_cluster", "card": smi,
                    "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    pinned("shard_bench")
    sb = run_shard_bench(dev)
    paths["shard_bench_local"], paths["shard_bench_join"] = (sb["local_launches"],
                                                             sb["join_launches"])
    log(json.dumps({"phase": "shard_bench", "card": smi,
                    "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    pinned("multihost")
    paths.update(run_multihost_phase(dev, smi))
    log(json.dumps({"phase": "multihost", "card": smi, "seconds": time.perf_counter() - t0}))
    pinned("config3")
    paths["config3"] = run_config3(dev)["launches"]
    pinned("config4")
    paths["config4"] = run_config4(dev)["launches"]
    t0 = time.perf_counter()
    pinned("matview")
    paths["matview"] = run_matview(dev)["launches"]
    log(json.dumps({"phase": "matview", "card": smi, "seconds": time.perf_counter() - t0}))
    pinned("config5")
    paths["config5"] = run_config5(dev)["launches"]
    pinned("cluster_stream")
    paths["cluster_stream"] = run_cluster_stream(dev)["launches"]
    pinned("device_join")
    paths["device_join"] = run_device_join(dev, args.profile)["launches"]
    pinned("resident")
    paths["resident"] = run_resident(dev)["launches"]
    pinned("sorted")
    sorted_run = run_sorted(dev)
    paths["sorted"], paths["sorted_s1"] = sorted_run["launches"], sorted_run["s1_launches"]
    pinned("dicthist_library")
    check_dicthist_library(dev)
    pinned("ml")
    paths["ml"] = run_ml(dev)["launches"]
    run_cpu_route(dev)
    t0 = time.perf_counter()
    pinned("host_layers")
    paths["host_layers"] = run_host_layers(dev, smi)["launches"]
    log(json.dumps({"phase": "host_layers", "card": smi, "seconds": time.perf_counter() - t0,
                    "launches": {lib: {e: n for e, n in by.items() if n}
                                 for lib, by in paths["host_layers"].items() if any(by.values())}}))
    t0 = time.perf_counter()
    pinned("metadata_collect")
    md = run_metadata_collect(dev, smi)
    paths["metadata_collect"] = md["launches"]
    rows.append(md["row"])
    log(json.dumps({"phase": "metadata_collect", "card": smi,
                    "seconds": time.perf_counter() - t0,
                    "launches": {lib: {e: n for e, n in by.items() if n}
                                 for lib, by in md["launches"].items() if any(by.values())}}))
    log(json.dumps({"phase": "launches", "per_path": paths}))
    idle = [lib for lib in _build.KERNELS if not any(p_[lib] for p_ in paths.values())]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    for r in rows:
        lib, entry = r.pop("entry")
        path = r.pop("path")
        r["launches"] = paths[path][lib].get(entry, 0)
        log(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                        "host_us": r["shape"].get("host_us"),
                        "per_sink_ms": r.get("per_sink_ms"), "m1_k3_ms": r.get("m1_k3_ms"),
                        "launches": r["launches"], "shape": r["shape"], "card": smi}))
    log(json.dumps({"phase": "wall", "seconds": time.perf_counter() - t_start,
                    "card": smi}))
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
