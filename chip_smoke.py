#!/usr/bin/env python3
"""Chip smoke for spark_rapids_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA GPU (built for an H100: sm_90a), nvcc and triton. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's kernels from the sources in this checkout into
   spark_rapids_tpu_torch/build/ (nvcc for tile_group_reduce, on a host
   thread while step 3 makes the data; Triton compiles each tile_reduce
   program at its first launch);
3. generates TPC-H lineitem at 60,000,000 rows (SF10 size), orders at
   15,000,000 and customer at 1,500,000 (the JAX package's tpch_tables
   ratios) in 1,048,576-row chunks and moves each chunk to the card once;
4. holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it: tile_reduce (B1) at q6 and with a
   min/max/NaN program, its string lane (B2) at the two string-filtered
   aggregates' programs on a lineitem and an orders batch, and
   tile_group_reduce (B3), told the batch's group count, at q1
   (1,048,576 rows, 15 lanes, 6 groups), at six stress shapes (one
   group; 1024 uniform groups; sorted zipf runs with dead rows; one lane;
   17 lanes x 1024 groups; 40 lanes x 6 groups) and, after q3 has run,
   on every q3 join output batch that its partial aggregate hands the
   kernel; per shape it checks that two runs give the same bits and
   times the kernel warm (``device_ms``) and with a cold L2
   (``cold_device_ms``), beside the plain version, the bound and, for B3
   at q1 and at q3's widest batch, one ``index_add_`` call as the
   library yardstick; it also logs the read rate a cold torch.sum
   reaches, counts B3's atomics and shuffles in the SASS, and checks that murmur3 and the hash-claim grouping give the
   card the CPU's bits;
5. runs q6, q1, two string-filtered global aggregates (lineitem and
   orders) and q3 through TpuSession: per query a checked run with the
   launch counts set to 0 just before and read just after, then three
   timed runs; each result is held against an independent numpy
   computation over the same host data (``tpch_references``, in a
   ``host_worker`` process); for q3 it also logs each
   operator's self time;
5g. runs the Parquet scan and writer without the Arrow library (``scan_phase``,
   after q3, before the scalar phase; the host library built with g++ on
   a host thread since the smoke began): G1 writes the resident TPC-H
   tables' host lanes as tpch_tables' files (262,144 rows, snappy: 229
   lineitem, 58 orders, 6 customer files) on 8 writer threads into a
   fresh directory under the temporary directory or chiprun_out/,
   whichever has more free space, after checking it holds twice the
   lanes' bytes; G2 runs q6, q1 and q3 through ``tpch_tables`` under the
   COALESCING and the MULTITHREADED reader (a first run with every B1 /
   B3 launch held and a warm run; walls, the scan's share, upload and
   decode numbers) and the two string aggregates (B2) under COALESCING,
   each equal to numpy and to the resident tables' rows; G3 writes
   4,194,304 rows of every flat type (about 10% NULL; NaN, +-inf, -0.0,
   empty and multi-byte strings, dates and timestamps before 1582,
   DECIMAL(12,2) and DECIMAL(24,4)) under each codec the build has and
   reads them back bit-equal by the host decode (``types_worker``, a
   process of its own started with the smoke), and 1,048,576 rows of
   the same types through the card, and dates / timestamps under LEGACY;
   G4 writes orders
   partitioned by o_orderpriority and reads '1-URGENT' (partitionsPruned
   4) against numpy, and counts rows per file with input_file_name()
   against each footer; G5 reads the same files through the CPU
   engine's FileScan; G6 truncates and deletes a lineitem file: each
   raises naming it, and is skipped under ignoreCorruptFiles /
   ignoreMissingFiles, the counts equal numpy over the files left; the
   directory is removed at the end;
5h. runs BASELINE configs 4 and 5 through the port's Delta layer and
   ML hand-off (``delta_phase``, after 5g, before the scalar phase; the
   files under a fresh directory of the temporary directory or the
   repo's output directory, after checking it holds twice their bytes
   and that os.link works there): H1 the config 4 upsert (bench.py's shapes:
   k BIGINT, amount DOUBLE, flag INT; 8,388,608 target rows appended
   as version 1, a MERGE of 8,388,608 source rows, half matched, then
   an UPDATE), on table A with every version held against numpy (floats
   bit for bit) and ``history()``, then on table B for warm walls; each
   step's wall split into execute / encode / promote / log commit, rows/s,
   Parquet bytes written and read, transient peak; H2 a filtered SUM
   (B1) and a GROUP BY flag (B3, 4 groups) over B's scanned batches; H3
   on A: DELETE, OPTIMIZE ZORDER BY (k, flag) (rows in the numpy
   interleave's order), VACUUM (exactly the tombstoned files), two
   1,048,576-row appends whose commits meet (one lands through the OCC
   retry), a duplicate-key MERGE that raises; H4 16 micro-batches of
   262,144 rows exactly once, durable and relaxed (rows/s, ms a commit,
   the fsync overhead), a crash child of delta/streaming.py
   (``delta.commit.fsync:crash@3``, started by subprocess at the phase's
   start) that must exit 137, and its resume in this process, held
   against ``demo_expected`` with no .tmp and no unreferenced file after
   VACUUM; H5 B written in the standard Delta format partitioned by
   flag, then overwritten, read back at the head and at
   ``version_as_of=0``; H6 ``mortgage_etl(...).to_device_arrays()`` over
   1,048,576 loans (12,582,912 performance rows, the files and numpy's
   features made on a host thread since the phase began), first and
   warm, every feature column against numpy on the card, and
   SUM(orig_amount) WHERE state = 'CA' (B1 with B2); every B1 / B3
   launch of a first run held;
5b. runs the scalar expression library (``scalar_queries``: string
   functions, LIKE and regexes, date fields and date arithmetic, a time
   zone (America/Los_Angeles, or +08:00 where the machine has no tz
   database, which it logs), integral arithmetic, math, hashes, casts
   and FIRST / LAST) through ``session.sql`` over the same TPC-H tables:
   per query a first run and WARM_RUNS warm runs, each held against numpy and
   Python references over the host columns (``scalar_references``,
   computed in a ``host_worker`` process: started with the smoke, it
   generates the same host lanes from the same seeds and never touches
   the card);
   B3 must run under s1, s2, s4 and s6, B1 on every lineitem batch of
   s7;
5c. runs the DECIMAL type (``decimal_phase``): lineitem's l_quantity,
   l_extendedprice, l_discount and l_tax and orders' o_totalprice as
   DECIMAL(12,2), made on the card from the float lanes already there
   (x 100, truncated toward zero, as the JAX datagen makes a decimal);
   through ``session.sql`` a first run and WARM_RUNS warm runs each of D1 TPC-H q1
   (DECIMAL(22,2) / (36,4) / (38,6) sums, DECIMAL(16,6) AVGs: the
   two-limb multiply, segmented sum and overflow check over 60M rows),
   D2 q6 and D3 q3 (its DECIMAL(36,4) revenue the ORDER BY key: two sort
   words on the card), each held exactly against Python ints over the
   host lanes (``decimal_references``, in the references'
   ``host_worker`` process), with Spark's result types checked; D4 the exact 256-bit
   divide (DECIMAL(27,15)), round, casts to DOUBLE, BIGINT,
   DECIMAL(38,10) and STRING and a product chain NULL past 38 digits,
   row by row over lineitem's first 4,194,304 rows (cut so that its
   Python reference stays inside half a minute); D6 D1 under an injected
   RetryOOM and SplitAndRetryOOMs (equal to the clean run, a split
   reached) and a DECIMAL(38,6) batch spilled to host and disk and back
   bit-equal; walls, fact rows/s, peak and transient memory and the top
   operators' self times for each, and no B1 / B3 launch (their gates
   refuse decimal lanes); D5, after phase 7 on the NDS tables:
   ss_net_paid as DECIMAL(7,2) (TPC-DS's type) over all 28.8M
   store_sales rows, a ROWS running SUM (DECIMAL(17,2)) and a
   whole-partition AVG (DECIMAL(11,6)) per customer through two
   WindowExecs, held against numpy int64 scans on every row;
6. runs the NDS slice (``NDS_SLICE``, 20 star-join queries) as SQL
   text through ``session.sql`` over NDS tables generated in memory at
   ``scale_rows`` 28,800,000 (TPC-DS SF10's store_sales; q82 at
   2,880,000, SF1, because its join grows with the square of the scale;
   both generated on a host thread from phase 5h's end on,
   ``nds_batches_ahead``) and moved to the card, after phase 5c and
   before 5d (whose orders_json documents a second process builds
   meanwhile), then the ten window queries (``NDS_WINDOW``) on the
   same tables: per query a first run and WARM_RUNS warm runs, each held
   against a numpy reference written from the query text
   (``NdsNumpy``) and checked to be in ORDER BY order, a warm run
   launching what the first did, and B3 held
   against its plain version on every batch it took; it logs wall
   times, fact rows/s, result rows, launches and ``pallasBatches`` per
   kernel and peak device memory, and checks that B3 carried q3, q42,
   q43, q52 and q55; then, on the inputs of the widest float group sum
   that q12 and q98 each make, it times the float group sums
   (``_seg_sum``) against one ``index_add_`` call and the hash-claim
   path's sort of the group ids, and checks that five runs of each give
   the same bits;
5d. runs the nested types (``nested_phase``) over the same tables:
   ``orders_nested`` (models/nested.py: lineitem stably sorted on
   l_orderkey and cut into orders of 1-7 lines, five arrays of 60M
   elements over about 15M orders) built on a host thread from phase
   5b on and moved to the card through the flat host lanes in
   1,048,576-row batches, and
   ``orders_json`` (NESTED_JSON_ROWS documents of the first orders,
   built in a second ``host_worker`` process);
   N1-N7: posexplode of arrays_zip grouped by position (B3), the
   lambdas and the fold (zip_with, aggregate, filter, exists, forall),
   fifteen collection functions as checksums and one order range row by
   row, the map functions, structs and explode_outer (B1 under its
   global aggregate), get_json_object through ``session.sql`` grouped
   by priority (B3), collect_list by the skewed l_orderkey; a first run
   each with every B1 / B3 launch held and WARM_RUNS warm runs, against numpy
   segment reductions over the sorted host lanes on a host thread and
   Python's json in ``host_worker``; walls, elements/s, peak and
   transient memory, the fold's steps;
5f. runs ANSI mode, the DataFrame surface and the rest of the expression
   library (``surface_phase``) over the same tables: E1 q6 / q1 under
   ``srt.sql.ansi.enabled`` (B1 / B3 launched as without it), E2 the
   errors of models/surface.py at scale (the JAX package's type and
   first message line under ANSI, numpy's rows without), E3
   ``range(0, 2^28)`` through B1, ``sample``, the ``GroupedData``
   shorthands (B3), ``count`` / ``sort_desc`` / ``to_pydict`` and
   ``explain(metrics=True)``, E4 bitwise over the keys, E5
   ``approx_percentile`` by (flag, status) within its rank bound and the
   exact ``percentile`` (its one CPU Aggregate), E6 a bloom filter built
   on the card (bits equal numpy's), ``might_contain`` over 60M rows,
   4,194,304 uuids, ``spark_partition_id`` / ``version`` and
   ``raise_error`` under IF, E7 a decimal UNION over 120M rows, the byte
   hashes of DECIMAL(24,4), explode of N4's maps and ``from_json`` /
   ``to_json`` in SQL over N6's first documents (CPU engine); a first
   run each with every B1 / B3 launch held and WARM_RUNS warm runs, against
   numpy / Python (``surface_references`` in ``host_worker``);
5e. runs the mixed device / CPU-engine plans (``fallback_phase``,
   after the NDS slice, on the resident TPC-H, DECIMAL and NDS tables):
   F1-F5 of models/fallback.py, each sending one operator to the CPU
   engine for a reason its ``explain("NOT_ON_TPU")`` states (checked
   against ``CPU_NODES``), and F6, TPC-H q6 and q1 with
   ``srt.sql.enabled=false`` over lineitem's first 3,000,000 rows; a
   first run with every B1 / B3 launch held (B1 under F2, B3 under F1
   and F4, above a HostToDevice seam) and WARM_RUNS warm runs, against numpy,
   ``re`` and ``decimal`` references from a ``host_worker`` process
   (F5's from NdsNumpy); walls, rows and bytes across the seams, the
   CPU engine's seconds. Every plan outside this phase must have no
   CPU-engine node (``guarded_planner``);
6b. runs the 18 joins and set operations (``NDS_JOINS_SETOPS``: left
   and full outer joins, cross products, UNION ALL, INTERSECT, EXCEPT)
   on the same tables, plus ``Q93_OUTER`` (q93's left outer join
   without the JOIN that no row passes): q93, q97, q90, q28, q38, q87,
   q71, q33 and ``Q93_OUTER`` a first run and WARM_RUNS warm runs each
   held against ``NdsNumpy``,
   the other ten a first run (JOINS_WARM_RUNS warm runs), and, at
   ``scale_rows`` 100,000, the card's rows against the port's own CPU
   run (the plain versions, which the CPU tests hold against the JAX
   package: this checks the CUDA path, not the semantics); B1 held
   against its plain version on every batch of the global aggregates
   it took (q28, q38, q61, q87, q90), B3 on every batch it took;
6c. runs the 33 queries of ``NDS_SUBQUERY`` (subquery predicates,
   COUNT(DISTINCT)), ``NDS_ROLLUP`` (ROLLUP with GROUPING()) and
   ``NDS_FUNCS`` (round, stddev_samp, q49, q75) on the same tables, plus
   ``Q10_OR`` (q10 without the county filter no address meets), with
   the plan-time subqueries' share of the first run logged; q6, q94,
   q10, q69, q45, q27, q36, q17, q2 and ``Q10_OR`` a first run and
   WARM_RUNS warm runs each held against ``NdsNumpy`` (q17 on its own
   tables at ``NDS_Q17_ROWS``, as its join grows with the cube of the
   scale), the others a first run (as in 6b) and, at 100,000 rows,
   the card's rows
   against the port's CPU run (q67 against the CPU's ROLLUP sums
   ``Q67_ROLLUP`` with ties left open, as B3 rounds a sum in another
   order than its plain version, and its RANK breaks exact ties of
   float sums by that rounding; ``Q67_ROLLUP`` itself against the CPU's
   rows); B1 and B3 held against their plain versions on
   every batch they took, the plan-time subqueries' included; B3 must
   run under the ROLLUP queries of ``NDS_ROLLUP_B3_QUERIES``;
7. runs two windows over all 28,800,000 store_sales rows, partitioned
   by the zipf-skewed ``ss_customer_sk`` (its 2% NULL partition
   included): (a) ROW_NUMBER, RANK and a ROWS running SUM, which the
   planner must give to BatchedRunningWindowExec over 28 sorted
   1,048,576-row batches, and (b) a whole-partition SUM and a LAG,
   through two WindowExecs; each first run and WARM_RUNS warm runs are held
   against numpy (a stable sort and segment scans) on every row, with
   wall times, rows/s, peak device memory and operator self times;
   window (a)'s sort runs out of core (28.8M rows above the default
   ``srt.sql.sort.oocRowBudget``);
7b. the memory phase: (a) ORDER BY (customer, date, item) over all
   28.8M store_sales rows at the default out-of-core row budget
   (4,194,304: 28 runs and the k-way chunk merge) and in core, each held
   against numpy's stable sort on every row and against each other, with
   each path's transient peak (``max_memory_allocated`` minus what was
   resident) and spilled bytes; (b) the queries of ``CAPPED_QUERIES``
   (window (a) and q82) uncapped and then under a cap of what is resident plus 75% of their
   uncapped transient peak (``torch.cuda.set_per_process_memory_fraction``
   and ``srt.memory.tpu.poolSize``), logged before the run: rows equal to
   the uncapped run's, spill, retry or split counted, the peak at or
   under the cap; (c) TPC-H q1 (B3), q6 (B1), the lineitem string
   aggregate (B1 with B2) and NDS q3 with a RetryOOM and then a
   SplitAndRetryOOM injected at two allocation attempts spread over the
   clean run's: each run equal to the clean one, each injection reaching
   a retry or a split, every B1 / B3 launch held against its plain
   version on the same inputs, one more launch per split; (d) the rate
   of one 1 GB SpillableBatch's device -> pinned host -> device copies
   beside the PCIe link's nominal rate;
8. logs TPC-H q3's operator self times and profiles one nested N2 (the
   lambdas and the fold) and one run of window (a), in core
   (torch.profiler: device time by kernel and the device's idle share).
   The q3 and decimal D1 profiles are cut, and no NDS query is
   profiled, so that the smoke stays inside its time: the profiler's
   work grows with the run's launches (q3's 25-32 s, D1's about 37 s,
   a profiled NDS run 40-70 s, q47's about 150 s). Profiles come last,
   because every profiler session slows the host's later launches;
9. prints one JSON line of kernel numbers, then
   {"ok": true, "device": {...}} as its last line.

Every query's first run holds each B1 / B3 launch against the kernel's
plain version on the same inputs (``holding_launches``); warm runs are
timed outside the hold. WARM_RUNS is 0, so that the smoke stays inside
its 1200 s on slower hosts: the queries of phases 5b-5f and 6-7 run
once, their walls the held first run's; steps 5, 5g and 5h keep their
warm runs.

Any mismatch or error exits non-zero before the last line is printed.
"""

import datetime
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROWS = 60_000_000
BATCH_ROWS = 1 << 20
RTOL = 1e-9  # float64 on both sides; only the summation order differs
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP64 FLOP/s
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12
TIMED_RUNS = 10
FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
#: NDS scale: TPC-DS SF10's store_sales has 28,800,991 rows
NDS_ROWS = 28_800_000
#: q82 joins inventory to store_sales on the item alone, so its join
#: output grows with the square of the scale: it runs at SF1
NDS_Q82_ROWS = 2_880_000
#: the B3 queries at any scale (few hundred groups at most per batch)
NDS_B3_QUERIES = ("q3", "q42", "q43", "q52", "q55")
NDS_FACTS = ("store_sales", "store_returns", "catalog_sales", "web_sales",
             "inventory")
#: warm runs after each query's held first run in phases 5b-5f (but
#: 5g and 5h, which time their readers and commits warm), 6, 6b, 6c
#: and 7: each is held against the rows and launch counts of the first,
#: and the query's wall is their median (the first run's without one).
#: None: on slower hosts the smoke ran past its 1200 s with them (about
#: 160 s of a 905 s run on a fast host, PERF.md section 6); every query
#: still runs once, held against its reference with every B1 / B3
#: launch held against the plain version
WARM_RUNS = 0
#: the same for the 34 queries of 6b and 6c held against their own
#: first run (and checked against the CPU at JOINS_CROSS_ROWS)
JOINS_WARM_RUNS = 0
#: the NDS_JOINS_SETOPS queries held against NdsNumpy at SF10, one or
#: more per new operator; the other ten are held, at JOINS_CROSS_ROWS,
#: against the port's own run with device="cpu" (at 100,000 rows: the
#: CPU engine's runs of q4, q11, q74 and q14 took 39 s at 200,000)
JOINS_NUMPY = ("q93", "q97", "q90", "q28", "q38", "q87", "q71", "q33")
JOINS_CROSS_ROWS = 100_000
#: the phase-6c queries held against NdsNumpy, one per mechanism: a
#: correlated scalar subquery (q6), EXISTS / NOT EXISTS with a residual
#: and COUNT(DISTINCT) (q94), EXISTS under OR (q10, and Q10_OR below),
#: NOT EXISTS (q69), IN (subquery) under OR (q45), ROLLUP with GROUPING()
#: (q27), RANK over a ROLLUP (q36), stddev_samp (q17), round (q2); the
#: other 24 are held like the ten of JOINS_CROSS_ROWS
SUBQ_NUMPY = ("q6", "q94", "q10", "q69", "q45", "q27", "q36", "q17", "q2")
#: q17 joins store_sales, store_returns and catalog_sales on (customer,
#: item) before its date filter; the zipf customer keys make that join
#: grow with the cube of the scale (the smoke logs its size at SF10 and
#: here), so q17 runs on tables of this scale
NDS_Q17_ROWS = 200_000
#: the ROLLUP queries whose expanded groupings reach B3 at every scale
#: (at 20,000 rows in tests/test_torch_nds.py, and at SF10 on the card;
#: q14 takes it at 20,000 rows only)
NDS_ROLLUP_B3_QUERIES = ("q5", "q36", "q67", "q70", "q77", "q80", "q86")
#: q93's left outer join without its JOIN reason, whose
#: r_reason_desc = 'reason 3' no row meets (ROADMAP.md C3): every
#: store_sales row, null-extended where no return matches
Q93_OUTER = """
        SELECT ss_customer_sk, SUM(act_sales) AS sumsales, COUNT(*) AS n,
               COUNT(sr_ticket_number) AS returned
        FROM (SELECT ss_customer_sk, sr_ticket_number,
                     CASE WHEN sr_return_quantity IS NOT NULL
                          THEN (ss_quantity - sr_return_quantity) *
                               ss_sales_price
                          ELSE ss_quantity * ss_sales_price
                          END AS act_sales
              FROM store_sales
              LEFT JOIN store_returns
                ON sr_item_sk = ss_item_sk
                   AND sr_ticket_number = ss_ticket_number) t
        GROUP BY ss_customer_sk
        ORDER BY ss_customer_sk"""
#: the window queries whose float group sums are timed alone
#: (expr/aggregates.py _seg_sum against index_add_) at SF10
SEG_SUM_QUERIES = ("q12", "q98")
#: q67's ROLLUP aggregate without the RANK over it
Q67_ROLLUP = """
        SELECT i_category, i_class, i_brand, s_store_id,
               SUM(ss_sales_price * ss_quantity) AS sumsales
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN store ON ss_store_sk = s_store_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE d_month_seq BETWEEN 1176 AND 1187
        GROUP BY ROLLUP (i_category, i_class, i_brand, s_store_id)"""
#: q10's EXISTS-under-OR without its ca_county IN ('county1', ...), which
#: no generated address meets (ROADMAP.md C3): the existence markers
#: over left outer joins then decide which customers count
Q10_OR = """
        SELECT cd_gender, cd_marital_status, cd_education_status,
               COUNT(*) AS cnt1, cd_purchase_estimate, COUNT(*) AS cnt2
        FROM customer c
        JOIN customer_address ca ON c.c_current_addr_sk = ca.ca_address_sk
        JOIN customer_demographics ON cd_demo_sk = c.c_current_cdemo_sk
        WHERE c.c_customer_sk IN
              (SELECT ss_customer_sk FROM store_sales
               JOIN date_dim ON ss_sold_date_sk = d_date_sk
               WHERE d_year = 1999 AND d_moy BETWEEN 1 AND 8)
          AND (EXISTS (SELECT 1 FROM web_sales
                       JOIN date_dim ON ws_sold_date_sk = d_date_sk
                       WHERE ws_bill_customer_sk = c.c_customer_sk
                         AND d_year = 1999 AND d_moy BETWEEN 1 AND 8)
               OR EXISTS (SELECT 1 FROM catalog_sales
                          JOIN date_dim ON cs_sold_date_sk = d_date_sk
                          WHERE cs_bill_customer_sk = c.c_customer_sk
                            AND d_year = 1999
                            AND d_moy BETWEEN 1 AND 8))
        GROUP BY cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate
        ORDER BY cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate
        LIMIT 100"""


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_T0 = time.perf_counter()


def log(msg):
    """One line of the smoke's log, after the seconds since it began."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def device_ms(torch, fn, runs=TIMED_RUNS, per_run=20):
    """Median device time of one ``fn()`` call, in ms: each run enqueues
    ``per_run`` calls behind a GPU sleep, so the events bracket device
    work only and not the host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def cold_device_ms(torch, fn, calls=2 * TIMED_RUNS):
    """Median device time of one ``fn()`` call that finds the L2 cache
    cold, as the main path does (it reads each batch once): before each
    call, outside its events, a 128 MB buffer is read through."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP64_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def warm_note(walls):
    """The warm runs' walls (s) for a log line."""
    if not walls:
        return "no warm run"
    return (f"warm median {statistics.median(walls):.4f} of "
            f"{[round(w, 4) for w in walls]} s")


def untimed(ms):
    return "not timed" if ms is None else f"{ms:.4f}"


def count_nodes(expr):
    return 1 + sum(count_nodes(c) for c in expr.children)


def days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def operator_self_ms(node, metrics, out, seen=None):
    """{operator: self time in ms} from the host-clock opTime metrics,
    which include the time a node spends pulling its children. A
    subtree that two parents share (both sides of a full outer join
    run under its left outer join and again under its anti join) is
    listed once, and its metrics hold both runs."""
    seen = set() if seen is None else seen
    if node.exec_id in seen:
        return out
    seen.add(node.exec_id)

    def incl(n):
        m = metrics.get(n.exec_id, {}).get("opTime")
        return m.value if m is not None else 0
    name = node.node_description().split("[")[0]
    key, k = name, 2
    while key in out:
        key, k = f"{name}#{k}", k + 1
    out[key] = (incl(node) - sum(incl(c) for c in node.children)) / 1e6
    for c in node.children:
        operator_self_ms(c, metrics, out, seen)
    return out


def shares_subtrees(node, seen=None):
    """Whether a physical plan runs a subtree twice (a full outer join)."""
    seen = set() if seen is None else seen
    if node.exec_id in seen:
        return True
    seen.add(node.exec_id)
    return any(shares_subtrees(c, seen) for c in node.children)


def host_match(np, hs, lit, prefix=False):
    """numpy: rows of a host string lane equal to (or starting with)
    the bytes ``lit``."""
    lens = np.diff(hs.offsets)
    hit = lens >= len(lit) if prefix else lens == len(lit)
    last = max(hs.chars.shape[0] - 1, 0)
    for j, byte in enumerate(lit):
        pos = np.minimum(hs.offsets[:-1] + j, last)
        hit &= hs.chars[pos] == byte
    return hit


class Key(tuple):
    """(values, valid) of a column's rows, as ``NdsNumpy.col`` and
    ``NdsNumpy.take`` give them; a string column's also carries
    ``codes``, each row's integer code (equal strings, equal codes),
    which ``NdsNumpy.group`` groups by instead of hashing the strings.
    Only those two make one, from the column's codes at the same rows:
    an array computed from the values never carries codes."""

    def __new__(cls, values, ok, codes=None):
        key = super().__new__(cls, (values, ok))
        key.codes = codes
        return key


class NdsNumpy:
    """numpy references for the NDS slice, written from the query texts
    (spark_rapids_tpu_torch/models/nds.py) over the generated host
    tables and independent of the port's code: filters are masks,
    equi-joins go by sort and searchsorted, grouping by np.unique with
    return_inverse and np.bincount, ordering by np.lexsort. SQL null
    rules: a null key joins nothing, a predicate on a null is not true,
    SUM and AVG skip nulls and are null over no value, and a CASE whose
    condition is not true takes its ELSE."""

    def __init__(self, np, tables):
        self.np = np
        self.tables = tables
        self._cols = {}
        self._full_lookups = {}
        self._sorted_dims = {}

    def col(self, table, name):
        """(values, valid) of one column as a ``Key``; strings as an
        object array with their codes, made once per column so that
        grouping by a string does not hash Python strings per query."""
        key = (table, name)
        if key not in self._cols:
            c = self.tables[table].column(name)
            values, codes = c.values, None
            if hasattr(values, "to_objects"):
                values = values.to_objects()
                index = {}
                codes = self.np.fromiter(
                    (index.setdefault(v, len(index)) for v in values),
                    self.np.int64, len(values))
            self._cols[key] = Key(values, c.mask, codes)
        return self._cols[key]

    def rows(self, table):
        return self.tables[table].num_rows

    # --- relational pieces ------------------------------------------------
    def lookup(self, dim, dim_key, fact_key, fact_ok):
        """Row of ``dim`` whose (unique, non-null) key equals each fact
        key, and whether there is one."""
        np = self.np
        got = self._sorted_dims.get((dim, dim_key))
        if got is None:
            keys, _ = self.col(dim, dim_key)
            order = np.argsort(keys, kind="stable")
            sk = keys[order]
            lo = int(sk[0]) if len(sk) else 0
            span = int(sk[-1]) - lo + 1 if len(sk) else 0
            dense = None
            if keys.dtype.kind in "iu" and span <= 4 * len(sk) + 1024:
                # surrogate keys: a table from key to row, one gather
                # per fact row instead of a binary search
                dense = np.full(span, -1, np.int64)
                dense[sk - lo] = order
            got = self._sorted_dims[(dim, dim_key)] = (order, sk, lo, dense)
        order, sk, lo, dense = got
        if dense is not None:
            at = np.asarray(fact_key, np.int64) - lo
            inside = (at >= 0) & (at < len(dense))
            row = dense[np.where(inside, at, 0)]
            hit = fact_ok & inside & (row >= 0)
            return np.where(hit, row, 0), hit
        pos = np.searchsorted(sk, fact_key).clip(0, len(sk) - 1)
        return order[pos], fact_ok & (sk[pos] == fact_key)

    def pairs(self, lkey, lok, rkey, rok):
        """Every (left row, right row) with equal non-null int keys."""
        np = self.np
        r = np.nonzero(rok)[0]
        r = r[np.argsort(rkey[r], kind="stable")]
        sk = rkey[r]
        left = np.nonzero(lok)[0]
        lo = np.searchsorted(sk, lkey[left], "left")
        cnt = np.searchsorted(sk, lkey[left], "right") - lo
        li = np.repeat(left, cnt)
        within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt,
                                                       cnt)
        return li, r[np.repeat(lo, cnt) + within]

    def group(self, keys):
        """Group ids over (values, valid) key columns (a null key is a
        group of its own), their count and each group's first row."""
        np = self.np
        combined = np.zeros(len(keys[0][0]), np.int64)
        for key in keys:
            values, ok = key
            codes = getattr(key, "codes", None)
            if codes is not None:
                # strings taken from a column: the column's codes
                uniq, inv = np.unique(codes, return_inverse=True)
                n = len(uniq)
            elif values.dtype == object:
                # strings: one dict pass (np.unique would sort Python
                # objects)
                index = {}
                inv = np.fromiter((index.setdefault(v, len(index))
                                   for v in values), np.int64, len(values))
                n = len(index)
            else:
                uniq, inv = np.unique(values, return_inverse=True)
                n = len(uniq)
            combined = combined * (n + 1) + np.where(ok, inv.reshape(-1) + 1,
                                                     0)
        _, first, gid = np.unique(combined, return_index=True,
                                  return_inverse=True)
        return gid.reshape(-1), len(first), first

    def gsum(self, gid, n, values, ok, integral=False):
        """SUM per group: (sums, valid); null where a group has no
        value."""
        np = self.np
        s = np.bincount(gid, weights=np.where(ok, values, 0).astype(
            np.float64), minlength=n)
        cnt = np.bincount(gid, weights=ok.astype(np.float64), minlength=n)
        return (s.astype(np.int64) if integral else s), cnt > 0

    def gavg(self, gid, n, values, ok):
        np = self.np
        s, valid = self.gsum(gid, n, values, ok)
        cnt = np.bincount(gid, weights=ok.astype(np.float64), minlength=n)
        return s / np.where(valid, cnt, 1.0), valid

    def result(self, cols, order, limit=None, hidden=()):
        """Rows of ``cols`` ({name: (values, valid)} in SELECT order),
        sorted by ``order`` ([(name, ascending)], Spark's null order)
        through np.lexsort and cut to ``limit``; ``hidden`` columns only
        order the rows."""
        np = self.np
        names = [c for c in cols if c not in hidden]
        n = len(cols[names[0]][0])
        lex = []
        for name, asc in order:
            values, ok = cols[name]
            if values.dtype == object:
                filled = np.where(ok, values, "")
                values = np.unique(filled, return_inverse=True)[1].reshape(-1)
            key = np.where(ok, values, 0)
            lex.append(np.where(ok, 1, 0) if asc else np.where(ok, 0, 1))
            lex.append(key if asc else -key)
        idx = np.lexsort(lex[::-1]) if lex else np.arange(n)
        idx = idx[:limit] if limit is not None else idx
        out = []
        for i in idx:
            row = {}
            for name in names:
                values, ok = cols[name]
                v = values[i]
                row[name] = None if not ok[i] else (
                    v if isinstance(v, str) else v.item())
            out.append(row)
        return out

    def keys_of(self, keys, first, names):
        """Each group's key values from its first row."""
        return {name: (values[first], ok[first])
                for name, (values, ok) in zip(names, keys)}

    # --- shared shapes ------------------------------------------------------
    def fact_dims(self, fact, fk_dims, where=None):
        """Fact rows (``where``: a bool mask, or all) joined to
        dimensions by unique keys, in the order given (the most selective
        first keeps the later lookups short): ``fk_dims`` is [(fact key,
        dim, dim key, dim filter or None)]; returns (kept fact rows,
        {dim: dim row per kept fact row})."""
        np = self.np
        idx = None if where is None else np.nonzero(where)[0]
        rows = {}
        for fk, dim, dk, dim_keep in fk_dims:
            v, ok = self.col(fact, fk)
            # a whole fact column against a dimension, once: many
            # queries share it, and a subset of rows gathers from it
            key = (fact, fk, dim, dk)
            if key not in self._full_lookups:
                self._full_lookups[key] = self.lookup(dim, dk, v, ok)
            pos, hit = self._full_lookups[key]
            if idx is None:
                hit = hit.copy()
                idx = np.arange(len(v))
            else:
                pos, hit = pos[idx], hit[idx]
            if dim_keep is not None:
                hit &= dim_keep[pos]
            idx = idx[hit]
            rows = {d: p[hit] for d, p in rows.items()}
            rows[dim] = pos[hit]
        return idx, rows

    def take(self, table, name, rows):
        key = self.col(table, name)
        values, ok = key
        return Key(values[rows], ok[rows],
                   None if key.codes is None else key.codes[rows])

    def eq(self, table, name, value):
        values, ok = self.col(table, name)
        return ok & (values == value)

    def between(self, table, name, lo, hi):
        values, ok = self.col(table, name)
        return ok & (values >= lo) & (values <= hi)

    def isin(self, table, name, choices):
        values, ok = self.col(table, name)
        return ok & self.np.isin(values, list(choices))

    def dates(self, **eqs):
        keep = self.np.ones(self.rows("date_dim"), bool)
        for name, value in eqs.items():
            keep &= self.eq("date_dim", name, value)
        return keep

    def star_sum(self, fact, fk_dims, key_cols, sums, order, limit=100,
                 where=None):
        """Fact x dimensions -> GROUP BY dimension columns -> SUMs of
        fact columns: ``key_cols`` [(output name, dim, column)], ``sums``
        [(output name, fact column)]."""
        idx, dims = self.fact_dims(fact, fk_dims, where)
        keys = [self.take(dim, c, dims[dim]) for _, dim, c in key_cols]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, [k for k, _, _ in key_cols])
        for name, c in sums:
            cols[name] = self.gsum(gid, n, *self.take(fact, c, idx))
        return self.result(cols, order, limit)

    # --- the queries ----------------------------------------------------------
    def q3(self):
        return self.star_sum(
            "store_sales",
            [("ss_sold_date_sk", "date_dim", "d_date_sk",
              self.dates(d_moy=11)),
             ("ss_item_sk", "item", "i_item_sk",
              self.eq("item", "i_manufact_id", 7))],
            [("d_year", "date_dim", "d_year"),
             ("brand_id", "item", "i_brand_id"),
             ("brand", "item", "i_brand")],
            [("sum_agg", "ss_ext_sales_price")],
            [("d_year", True), ("sum_agg", False), ("brand_id", True)])

    def _demo_avgs(self, fact, p, demo_fk, gender, marital, education,
                   promo, aggs):
        cd = (self.eq("customer_demographics", "cd_gender", gender)
              & self.eq("customer_demographics", "cd_marital_status",
                        marital)
              & self.eq("customer_demographics", "cd_education_status",
                        education))
        fk = [(demo_fk, "customer_demographics", "cd_demo_sk", cd),
              (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
               self.dates(d_year=1998)),
              (f"{p}_item_sk", "item", "i_item_sk", None)]
        if promo:
            fk.append((f"{p}_promo_sk", "promotion", "p_promo_sk",
                       self.eq("promotion", "p_channel_email", "N")
                       | self.eq("promotion", "p_channel_event", "N")))
        idx, dims = self.fact_dims(fact, fk)
        keys = [self.take("item", "i_item_id", dims["item"])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["i_item_id"])
        for name, c in aggs:
            cols[name] = self.gavg(gid, n, *self.take(fact, c, idx))
        return self.result(cols, [("i_item_id", True)], 100)

    def q7(self):
        return self._demo_avgs(
            "store_sales", "ss", "ss_cdemo_sk", "M", "S", "College", True,
            [("agg1", "ss_quantity"), ("agg2", "ss_list_price"),
             ("agg3", "ss_coupon_amt"), ("agg4", "ss_sales_price")])

    def q26(self):
        return self._demo_avgs(
            "catalog_sales", "cs", "cs_bill_customer_sk", "F", "W",
            "Primary", False,
            [("agg1", "cs_quantity"), ("agg2", "cs_list_price"),
             ("agg4", "cs_sales_price")])

    def q15(self):
        idx, dims = self.fact_dims("catalog_sales", [
            ("cs_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_qoy=1, d_year=1999)),
            ("cs_bill_customer_sk", "customer", "c_customer_sk", None)])
        addr, hit = self.lookup("customer_address", "ca_address_sk",
                                *self.take("customer", "c_current_addr_sk",
                                           dims["customer"]))
        state = self.isin("customer_address", "ca_state",
                          ("CA", "WA", "GA"))[addr]
        price, pok = self.take("catalog_sales", "cs_sales_price", idx)
        keep = hit & (state | (pok & (price > 250.0)))
        idx, addr = idx[keep], addr[keep]
        keys = [self.take("customer_address", "ca_zip", addr)]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["ca_zip"])
        cols["sum_sales"] = self.gsum(
            gid, n, *self.take("catalog_sales", "cs_sales_price", idx))
        return self.result(cols, [("ca_zip", True)], 100)

    def q19(self):
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_moy=11, d_year=1998)),
            ("ss_item_sk", "item", "i_item_sk",
             self.eq("item", "i_manager_id", 8)),
            ("ss_customer_sk", "customer", "c_customer_sk", None),
            ("ss_store_sk", "store", "s_store_sk", None)])
        addr, hit = self.lookup("customer_address", "ca_address_sk",
                                *self.take("customer", "c_current_addr_sk",
                                           dims["customer"]))
        ca_state, ca_ok = self.take("customer_address", "ca_state", addr)
        s_state, s_ok = self.take("store", "s_state", dims["store"])
        keep = hit & ca_ok & s_ok & (ca_state != s_state)
        idx, item = idx[keep], dims["item"][keep]
        names = [("brand_id", "i_brand_id"), ("brand", "i_brand"),
                 ("i_manufact_id", "i_manufact_id"),
                 ("i_manufact", "i_manufact")]
        keys = [self.take("item", c, item) for _, c in names]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, [k for k, _ in names])
        cols["ext_price"] = self.gsum(
            gid, n, *self.take("store_sales", "ss_ext_sales_price", idx))
        return self.result(cols, [("ext_price", False), ("brand_id", True),
                                  ("i_manufact_id", True)], 100)

    def q21(self):
        np = self.np
        idx, dims = self.fact_dims("inventory", [
            ("inv_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999)),
            ("inv_item_sk", "item", "i_item_sk",
             self.between("item", "i_current_price", 0.99, 50.49)),
            ("inv_warehouse_sk", "warehouse", "w_warehouse_sk", None)])
        keys = [self.take("warehouse", "w_warehouse_name",
                          dims["warehouse"]),
                self.take("item", "i_item_id", dims["item"])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["w_warehouse_name", "i_item_id"])
        qoh, qok = self.take("inventory", "inv_quantity_on_hand", idx)
        moy = self.take("date_dim", "d_moy", dims["date_dim"])[0]
        for name, when in (("inv_before", moy < 6), ("inv_after", moy >= 6)):
            # CASE WHEN .. THEN qoh ELSE 0: null only where qoh is taken
            cols[name] = self.gsum(gid, n, np.where(when, qoh, 0),
                                   np.where(when, qok, True), integral=True)
        after, aok = cols["inv_after"]
        having = aok & (after > 0)
        cols = {k: (v[having], ok[having]) for k, (v, ok) in cols.items()}
        return self.result(cols, [("w_warehouse_name", True),
                                  ("i_item_id", True)], 100)

    def q25(self):
        np = self.np
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_moy=4, d_year=1999)),
            ("ss_store_sk", "store", "s_store_sk", None),
            ("ss_item_sk", "item", "i_item_sk", None)])
        # (ticket, item) as one int64: tickets < 2^40, items < 2^20
        t, _ = self.take("store_sales", "ss_ticket_number", idx)
        it, _ = self.take("store_sales", "ss_item_sk", idx)
        rt, rtok = self.col("store_returns", "sr_ticket_number")
        ri, riok = self.col("store_returns", "sr_item_sk")
        li, rr = self.pairs(t * (1 << 20) + it, np.ones(len(idx), bool),
                            rt * (1 << 20) + ri, rtok & riok)
        names = [("i_item_id", "item", "i_item_id"),
                 ("i_item_desc", "item", "i_item_desc"),
                 ("s_store_id", "store", "s_store_id"),
                 ("s_store_name", "store", "s_store_name")]
        keys = [self.take(dim, c, dims[dim][li]) for _, dim, c in names]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, [k for k, _, _ in names])
        cols["store_sales_profit"] = self.gsum(
            gid, n, *self.take("store_sales", "ss_net_profit", idx[li]))
        cols["store_returns_loss"] = self.gsum(
            gid, n, *self.take("store_returns", "sr_net_loss", rr))
        return self.result(cols, [(k, True) for k, _, _ in names], 100)

    def _inventory_items(self, lo, hi, manufact, with_sales):
        """q37 / q82: the items in a price band and manufacturer set with
        an inventory row of 100-500 on hand (a date row for it; in 1999
        for q37), and for q82 a store sale: the GROUP BY with no
        aggregate keeps one row per item."""
        np = self.np
        items = (self.between("item", "i_current_price", lo, hi)
                 & self.isin("item", "i_manufact_id", manufact))
        where = self.between("inventory", "inv_quantity_on_hand", 100, 500)
        dates = None if with_sales else self.dates(d_year=1999)
        _, dims = self.fact_dims("inventory", [
            ("inv_item_sk", "item", "i_item_sk", items),
            ("inv_date_sk", "date_dim", "d_date_sk", dates)], where)
        keep = np.zeros(self.rows("item"), bool)
        keep[dims["item"]] = True
        if with_sales:
            _, sold = self.fact_dims("store_sales", [
                ("ss_item_sk", "item", "i_item_sk", keep)])
            keep = np.zeros(self.rows("item"), bool)
            keep[sold["item"]] = True
        rows = np.nonzero(keep)[0]
        names = ["i_item_id", "i_item_desc", "i_current_price"]
        keys = [self.take("item", c, rows) for c in names]
        gid, n, first = self.group(keys)
        return self.result(self.keys_of(keys, first, names),
                           [("i_item_id", True)], 100)

    def q37(self):
        return self._inventory_items(20.0, 50.0, (3, 8, 17, 19), False)

    def q82_join_rows(self):
        """The rows q82's joins produce before its GROUP BY: qualifying
        inventory rows times store sales, item by item."""
        np = self.np
        items = (self.between("item", "i_current_price", 30.0, 60.0)
                 & self.isin("item", "i_manufact_id", (2, 6, 12, 17)))
        _, inv = self.fact_dims("inventory", [
            ("inv_item_sk", "item", "i_item_sk", items),
            ("inv_date_sk", "date_dim", "d_date_sk", None)],
            self.between("inventory", "inv_quantity_on_hand", 100, 500))
        _, sold = self.fact_dims("store_sales", [
            ("ss_item_sk", "item", "i_item_sk", items)])
        n = self.rows("item")
        per_inv = np.bincount(inv["item"], minlength=n)
        per_ss = np.bincount(sold["item"], minlength=n)
        return int(items.sum()), int((per_inv * per_ss).sum())

    def q82(self):
        return self._inventory_items(30.0, 60.0, (2, 6, 12, 17), True)

    def q40(self):
        np = self.np
        idx, dims = self.fact_dims("catalog_sales", [
            ("cs_warehouse_sk", "warehouse", "w_warehouse_sk", None),
            ("cs_item_sk", "item", "i_item_sk", None),
            ("cs_sold_date_sk", "date_dim", "d_date_sk", None)])
        price = self.between("item", "i_current_price", 0.99,
                             1.49)[dims["item"]]
        year = self.eq("date_dim", "d_year", 1999)[dims["date_dim"]]
        keep = price | year
        idx = idx[keep]
        dims = {d: p[keep] for d, p in dims.items()}
        keys = [self.take("warehouse", "w_state", dims["warehouse"]),
                self.take("item", "i_item_id", dims["item"])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["w_state", "i_item_id"])
        sp, sok = self.take("catalog_sales", "cs_sales_price", idx)
        moy = self.take("date_dim", "d_moy", dims["date_dim"])[0]
        for name, when in (("sales_before", moy < 6),
                           ("sales_after", moy >= 6)):
            cols[name] = self.gsum(gid, n, np.where(when, sp, 0.0),
                                   np.where(when, sok, True))
        return self.result(cols, [("w_state", True), ("i_item_id", True)],
                           100)

    def q42(self):
        return self.star_sum(
            "store_sales",
            [("ss_sold_date_sk", "date_dim", "d_date_sk",
              self.dates(d_moy=12, d_year=1998)),
             ("ss_item_sk", "item", "i_item_sk", None)],
            [("d_year", "date_dim", "d_year"),
             ("i_category_id", "item", "i_category_id"),
             ("i_category", "item", "i_category")],
            [("total_sales", "ss_ext_sales_price")],
            [("total_sales", False), ("d_year", True),
             ("i_category_id", True), ("i_category", True)])

    def q43(self):
        np = self.np
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1998)),
            ("ss_store_sk", "store", "s_store_sk",
             self.eq("store", "s_gmt_offset", -5.0))])
        keys = [self.take("store", "s_store_name", dims["store"]),
                self.take("store", "s_store_id", dims["store"])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["s_store_name", "s_store_id"])
        sp, sok = self.take("store_sales", "ss_sales_price", idx)
        for name, d in (("sun_sales", "Sunday"), ("mon_sales", "Monday"),
                        ("fri_sales", "Friday"), ("sat_sales", "Saturday")):
            when = self.eq("date_dim", "d_day_name", d)[dims["date_dim"]]
            cols[name] = self.gsum(gid, n, np.where(when, sp, 0.0),
                                   np.where(when, sok, True))
        return self.result(cols, [("s_store_name", True),
                                  ("s_store_id", True)], 100)

    def q48(self):
        np = self.np
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999)),
            ("ss_store_sk", "store", "s_store_sk", None),
            ("ss_cdemo_sk", "customer_demographics", "cd_demo_sk", None),
            ("ss_addr_sk", "customer_address", "ca_address_sk", None)])
        cd = dims["customer_demographics"]
        price, pok = self.take("store_sales", "ss_sales_price", idx)
        keep = np.zeros(len(idx), bool)
        for m, e, lo, hi in (("M", "4 yr Degree", 100.0, 150.0),
                             ("D", "2 yr Degree", 50.0, 100.0),
                             ("S", "College", 150.0, 200.0)):
            demo = (self.eq("customer_demographics", "cd_marital_status", m)
                    & self.eq("customer_demographics",
                              "cd_education_status", e))
            keep |= demo[cd] & pok & (price >= lo) & (price <= hi)
        q, qok = self.take("store_sales", "ss_quantity", idx[keep])
        total = int(q[qok].sum()) if qok.any() else None
        return [{"total_quantity": total}]

    def _brand_month(self, manager, year, with_year):
        keys = [("brand_id", "item", "i_brand_id"),
                ("brand", "item", "i_brand")]
        order = [("ext_price", False), ("brand_id", True)]
        if with_year:
            keys.insert(0, ("d_year", "date_dim", "d_year"))
            order.insert(0, ("d_year", True))
        return self.star_sum(
            "store_sales",
            [("ss_sold_date_sk", "date_dim", "d_date_sk",
              self.dates(d_moy=11, d_year=year)),
             ("ss_item_sk", "item", "i_item_sk",
              self.eq("item", "i_manager_id", manager))],
            keys, [("ext_price", "ss_ext_sales_price")], order)

    def q52(self):
        return self._brand_month(1, 1999, True)

    def q55(self):
        return self._brand_month(4, 1999, False)

    def q62(self):
        np = self.np
        idx, dims = self.fact_dims("catalog_sales", [
            ("cs_ship_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999)),
            ("cs_warehouse_sk", "warehouse", "w_warehouse_sk", None)])
        keys = [self.take("warehouse", "w_warehouse_name",
                          dims["warehouse"])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["w_warehouse_name"])
        ship, _ = self.take("catalog_sales", "cs_ship_date_sk", idx)
        sold, sok = self.take("catalog_sales", "cs_sold_date_sk", idx)
        lag = ship - sold
        for name, when in (("d30", lag <= 30),
                           ("d60", (lag > 30) & (lag <= 60)),
                           ("dmore", lag > 60)):
            cols[name] = self.gsum(gid, n, (sok & when).astype(np.int64),
                                   np.ones(len(idx), bool), integral=True)
        return self.result(cols, [("w_warehouse_name", True)], 100)

    def _ticket_rollup(self, fk_dims, city_col, sums):
        """q68 / q79's derived table: store sales grouped by (ticket,
        customer, a city); returns its columns."""
        idx, dims = self.fact_dims("store_sales", fk_dims)
        dim, c, out = city_col
        keys = [self.take("store_sales", "ss_ticket_number", idx),
                self.take("store_sales", "ss_customer_sk", idx),
                self.take(dim, c, dims[dim])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first,
                            ["ss_ticket_number", "ss_customer_sk", out])
        for name, c in sums:
            cols[name] = self.gsum(gid, n,
                                   *self.take("store_sales", c, idx))
        return cols

    def q68(self):
        np = self.np
        hd = (self.eq("household_demographics", "hd_dep_count", 4)
              | self.eq("household_demographics", "hd_vehicle_count", 3))
        dates = self.between("date_dim", "d_dom", 1, 2) & \
            self.eq("date_dim", "d_year", 1999)
        dn = self._ticket_rollup(
            [("ss_sold_date_sk", "date_dim", "d_date_sk", dates),
             ("ss_store_sk", "store", "s_store_sk",
              self.isin("store", "s_city", ("city1", "city2"))),
             ("ss_hdemo_sk", "household_demographics", "hd_demo_sk", hd),
             ("ss_addr_sk", "customer_address", "ca_address_sk", None)],
            ("customer_address", "ca_city", "bought_city"),
            [("extended_price", "ss_ext_sales_price"),
             ("list_price", "ss_ext_list_price"),
             ("extended_tax", "ss_ext_tax")])
        cust, hit = self.lookup("customer", "c_customer_sk",
                                *dn["ss_customer_sk"])
        addr, ahit = self.lookup("customer_address", "ca_address_sk",
                                 *self.take("customer", "c_current_addr_sk",
                                            cust))
        city, cok = self.take("customer_address", "ca_city", addr)
        bought, bok = dn["bought_city"]
        keep = np.nonzero(hit & ahit & cok & bok & (city != bought))[0]
        cols = {"c_last_name": self.take("customer", "c_last_name",
                                         cust[keep]),
                "c_first_name": self.take("customer", "c_first_name",
                                          cust[keep]),
                "ca_city": (city[keep], cok[keep])}
        for name in ("bought_city", "ss_ticket_number", "extended_price",
                     "extended_tax", "list_price"):
            v, ok = dn[name]
            cols[name] = (v[keep], ok[keep])
        return self.result(cols, [("c_last_name", True),
                                  ("ss_ticket_number", True)], 100)

    def q79(self):
        np = self.np
        hd = (self.eq("household_demographics", "hd_dep_count", 6)
              | (self.col("household_demographics", "hd_vehicle_count")[1]
                 & (self.col("household_demographics",
                             "hd_vehicle_count")[0] > 2)))
        ms = self._ticket_rollup(
            [("ss_sold_date_sk", "date_dim", "d_date_sk",
              self.dates(d_dow=1, d_year=1998)),
             ("ss_store_sk", "store", "s_store_sk",
              self.between("store", "s_number_employees", 200, 295)),
             ("ss_hdemo_sk", "household_demographics", "hd_demo_sk", hd)],
            ("store", "s_city", "s_city"),
            [("amt", "ss_coupon_amt"), ("profit", "ss_net_profit")])
        cust, hit = self.lookup("customer", "c_customer_sk",
                                *ms["ss_customer_sk"])
        keep = np.nonzero(hit)[0]
        city, cok = ms["s_city"]
        cols = {"c_last_name": self.take("customer", "c_last_name",
                                         cust[keep]),
                "c_first_name": self.take("customer", "c_first_name",
                                          cust[keep]),
                "city_part": (np.array([s[:30] for s in city[keep]],
                                       dtype=object), cok[keep])}
        for name in ("ss_ticket_number", "amt", "profit"):
            v, ok = ms[name]
            cols[name] = (v[keep], ok[keep])
        return self.result(cols, [("c_last_name", True),
                                  ("c_first_name", True),
                                  ("city_part", True), ("profit", True)],
                           100)

    def q96(self):
        idx, _ = self.fact_dims("store_sales", [
            ("ss_hdemo_sk", "household_demographics", "hd_demo_sk",
             self.eq("household_demographics", "hd_dep_count", 3)),
            ("ss_store_sk", "store", "s_store_sk",
             self.eq("store", "s_store_name", "store7"))])
        return [{"cnt": len(idx)}]

    def q99(self):
        np = self.np
        idx, dims = self.fact_dims("web_sales", [
            ("ws_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999))])
        keys = [self.take("date_dim", "d_moy", dims["date_dim"])]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["d_moy"])
        q, qok = self.take("web_sales", "ws_quantity", idx)
        for name, when in (("small_q", q < 40),
                           ("mid_q", (q >= 40) & (q <= 70)),
                           ("big_q", q > 70)):
            cols[name] = self.gsum(gid, n, (qok & when).astype(np.int64),
                                   np.ones(len(idx), bool), integral=True)
        return self.result(cols, [("d_moy", True)])


    # --- the window queries (NDS_WINDOW) -----------------------------------
    def dim_codes(self, dim, name, rows):
        """A dimension column at ``rows`` as (int codes in value order,
        valid, values by code or None): a string column is factorized
        on its dimension once, so fact-length keys group as ints."""
        np = self.np
        key = ("codes", dim, name)
        if key not in self._cols:
            values, ok = self.col(dim, name)
            if values.dtype == object:
                uniq, inv = np.unique(np.where(ok, values, ""),
                                      return_inverse=True)
                self._cols[key] = (inv.reshape(-1), ok, uniq)
            else:
                self._cols[key] = (values, ok, None)
        codes, ok, uniq = self._cols[key]
        return codes[rows], ok[rows], uniq

    def grouped_codes(self, coded):
        """GROUP BY over dim_codes keys: (gid, n, each key at its
        group's first row as (codes, valid, values by code))."""
        gid, n, first = self.group([(c, ok) for c, ok, _ in coded])
        return gid, n, [(c[first], ok[first], u) for c, ok, u in coded]

    @staticmethod
    def decoded(key):
        codes, ok, uniq = key
        return (codes if uniq is None else uniq[codes]), ok

    def over(self, part, agg, values, ok):
        """SUM / AVG(values) OVER (PARTITION BY part) per row: part is a
        list of (values, valid) keys (a null key is a partition)."""
        pid, n, _ = self.group(part)
        out, valid = agg(pid, n, values, ok)
        return out[pid], valid[pid]

    def rank(self, part, order):
        """RANK() OVER (PARTITION BY part ORDER BY order) per row;
        ``order`` is [(values, valid, ascending)] in Spark's null order
        (first ascending, last descending); no partition is one."""
        np = self.np
        n = len(order[0][0])
        pid = self.group(part)[0] if part else np.zeros(n, np.int64)
        lex = [pid]
        for values, ok, asc in order:
            lex.append(np.where(ok, 1, 0) if asc else np.where(ok, 0, 1))
            key = np.where(ok, values, 0)
            lex.append(key if asc else -key)
        idx = np.lexsort(lex[::-1])
        sk = [a[idx] for a in lex]
        new_part = np.r_[True, sk[0][1:] != sk[0][:-1]]
        new_run = new_part.copy()
        for a in sk[1:]:
            new_run |= np.r_[True, a[1:] != a[:-1]]
        pos = np.arange(n)
        part_start = np.maximum.accumulate(np.where(new_part, pos, 0))
        run_start = np.maximum.accumulate(np.where(new_run, pos, 0))
        out = np.empty(n, np.int64)
        out[idx] = run_start - part_start + 1
        return out

    def _item_revenue(self, fact, p, categories, year, moys):
        """q12 / q20 / q98: item revenue and its share of its class."""
        np = self.np
        idx, dims = self.fact_dims(fact, [
            (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=year)
             & self.between("date_dim", "d_moy", *moys)),
            (f"{p}_item_sk", "item", "i_item_sk",
             self.isin("item", "i_category", categories))])
        names = ["i_item_id", "i_item_desc", "i_category", "i_class",
                 "i_current_price"]
        gid, n, keys = self.grouped_codes(
            [self.dim_codes("item", c, dims["item"]) for c in names])
        cols = {c: self.decoded(k) for c, k in zip(names, keys)}
        rev, rok = self.gsum(gid, n, *self.take(
            fact, f"{p}_ext_sales_price", idx))
        tot, tok = self.over([keys[3][:2]], self.gsum, rev, rok)
        ok = rok & tok & (tot != 0)
        cols["itemrevenue"] = (rev, rok)
        cols["revenueratio"] = (np.where(
            ok, rev * 100.0 / np.where(ok, tot, 1.0), 0.0), ok)
        return self.result(cols, [(c, True) for c in (
            "i_category", "i_class", "i_item_id", "i_item_desc",
            "revenueratio")], 100)

    def q12(self):
        return self._item_revenue("web_sales", "ws",
                                  ("Sports", "Books", "Home"), 1999, (2, 3))

    def q20(self):
        return self._item_revenue("catalog_sales", "cs",
                                  ("Jewelry", "Shoes", "Electronics"), 1999,
                                  (2, 3))

    def q98(self):
        return self._item_revenue("store_sales", "ss",
                                  ("Men", "Music", "Women"), 1998, (5, 6))

    def _class_pairs(self, first, second):
        """(i_category IN first[0] AND i_class IN first[1]) OR (the same
        for ``second``) over item rows."""
        return (self.isin("item", "i_category", first[0])
                & self.isin("item", "i_class", first[1])) | \
            (self.isin("item", "i_category", second[0])
             & self.isin("item", "i_class", second[1]))

    def _deviation(self, sums, sok, avg, aok, nonzero):
        """The outer WHERE of q53 / q63 / q89: CASE WHEN avg > 0 (avg <>
        0 for q89) THEN ABS(sum - avg) / avg ELSE NULL END > 0.1."""
        np = self.np
        when = aok & ((avg != 0) if nonzero else (avg > 0))
        return when & sok & (np.abs(sums - avg) / np.where(when, avg, 1.0)
                             > 0.1)

    def _avg_sales(self, item_cond, key, period, out, order):
        """q53 / q63: store sales per (item key, period) against the
        key's average over its periods."""
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.between("date_dim", "d_month_seq", 1176, 1187)),
            ("ss_item_sk", "item", "i_item_sk", item_cond),
            ("ss_store_sk", "store", "s_store_sk", None)])
        gid, n, keys = self.grouped_codes(
            [self.dim_codes("item", key, dims["item"]),
             self.dim_codes("date_dim", period, dims["date_dim"])])
        sums, sok = self.gsum(gid, n, *self.take("store_sales",
                                                 "ss_sales_price", idx))
        avg, aok = self.over([keys[0][:2]], self.gavg, sums, sok)
        keep = self._deviation(sums, sok, avg, aok, nonzero=False)
        k, kok = self.decoded(keys[0])
        cols = {out[0]: (k[keep], kok[keep]), "sum_sales": (
            sums[keep], sok[keep]), out[1]: (avg[keep], aok[keep])}
        return self.result(cols, order, 100)

    def q53(self):
        return self._avg_sales(
            self.isin("item", "i_category",
                      ("Books", "Children", "Electronics")),
            "i_manufact_id", "d_qoy",
            ("manufact_id", "avg_quarterly_sales"),
            [("avg_quarterly_sales", True), ("sum_sales", True),
             ("manufact_id", True)])

    def q63(self):
        return self._avg_sales(
            self._class_pairs((("Books", "Children", "Electronics"),
                               ("class1", "class2", "class3")),
                              (("Women", "Music", "Men"),
                               ("class4", "class5", "class6"))),
            "i_manager_id", "d_moy", ("manager_id", "avg_monthly_sales"),
            [("manager_id", True), ("avg_monthly_sales", True),
             ("sum_sales", True)])

    def q89(self):
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999)),
            ("ss_item_sk", "item", "i_item_sk", self._class_pairs(
                (("Books", "Electronics", "Sports"),
                 ("class1", "class2", "class3")),
                (("Men", "Jewelry", "Women"),
                 ("class4", "class5", "class6")))),
            ("ss_store_sk", "store", "s_store_sk", None)])
        names = [("i_category", "item"), ("i_class", "item"),
                 ("i_brand", "item"), ("s_store_name", "store"),
                 ("s_company_name", "store"), ("d_moy", "date_dim")]
        gid, n, keys = self.grouped_codes(
            [self.dim_codes(d, c, dims[d]) for c, d in names])
        sums, sok = self.gsum(gid, n, *self.take("store_sales",
                                                 "ss_sales_price", idx))
        avg, aok = self.over([k[:2] for k in (keys[0], keys[2], keys[3],
                                              keys[4])], self.gavg, sums, sok)
        keep = self._deviation(sums, sok, avg, aok, nonzero=True)
        cols = {c: tuple(a[keep] for a in self.decoded(k))
                for (c, _), k in zip(names, keys)}
        cols["sum_sales"] = (sums[keep], sok[keep])
        cols["avg_monthly_sales"] = (avg[keep], aok[keep])
        cols["__ord"] = (sums[keep] - avg[keep], sok[keep] & aok[keep])
        return self.result(cols, [("__ord", True), ("s_store_name", True),
                                  ("i_category", True), ("i_class", True),
                                  ("i_brand", True), ("d_moy", True)], 100,
                           hidden=("__ord",))

    def _monthly(self, fact, p, dim, dim_key, dim_name):
        """q47 / q57's v1: sales per (category, brand, outlet, year,
        month) with the outlet-year average: (keys, sums, sok, avg,
        aok)."""
        idx, dims = self.fact_dims(fact, [
            (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999)),
            (f"{p}_item_sk", "item", "i_item_sk", None),
            (dim_key[0], dim, dim_key[1], None)])
        coded = [self.dim_codes("item", "i_category", dims["item"]),
                 self.dim_codes("item", "i_brand", dims["item"])] + \
            [self.dim_codes(dim, c, dims[dim]) for c in dim_name] + \
            [self.dim_codes("date_dim", c, dims["date_dim"])
             for c in ("d_year", "d_moy")]
        gid, n, keys = self.grouped_codes(coded)
        sums, sok = self.gsum(gid, n, *self.take(fact, f"{p}_sales_price",
                                                 idx))
        avg, aok = self.over([k[:2] for k in keys[:-1]], self.gavg, sums,
                             sok)
        return keys, sums, sok, avg, aok

    def q47(self):
        np = self.np
        keys, sums, sok, avg, aok = self._monthly(
            "store_sales", "ss", "store", ("ss_store_sk", "s_store_sk"),
            ("s_store_name", "s_company_name"))
        rn = self.rank([k[:2] for k in keys[:4]],
                       [(k[0], k[1], True) for k in keys[4:]])
        # v1 joined to itself on (category, brand, store name) at rn - 1
        # and rn + 1 (the company name is not a join key)
        kid = self.group([k[:2] for k in keys[:3]])[0]
        kok = keys[0][1] & keys[1][1] & keys[2][1]
        base = kid * (int(rn.max()) + 3)
        v, lag = self.pairs(base + rn, kok, base + rn + 1, kok)
        i, lead = self.pairs(base[v] + rn[v], kok[v], base + rn - 1, kok)
        v, lag = v[i], lag[i]
        keep = aok[v] & (avg[v] > 0) & sok[v] & (
            np.abs(sums[v] - avg[v]) / np.where(aok[v] & (avg[v] > 0),
                                                 avg[v], 1.0) > 0.1)
        v, lag, lead = v[keep], lag[keep], lead[keep]
        cat, cok = self.decoded(keys[0])
        cols = {"i_category": (cat[v], cok[v]),
                "d_year": (keys[4][0][v], keys[4][1][v]),
                "d_moy": (keys[5][0][v], keys[5][1][v]),
                "avg_monthly_sales": (avg[v], aok[v]),
                "sum_sales": (sums[v], sok[v]),
                "psum": (sums[lag], sok[lag]),
                "nsum": (sums[lead], sok[lead]),
                "__ord": (sums[v] - avg[v], sok[v] & aok[v])}
        return self.result(cols, [("__ord", True), ("d_moy", True)], 100,
                           hidden=("__ord",))

    def q57(self):
        keys, sums, sok, avg, aok = self._monthly(
            "catalog_sales", "cs", "call_center",
            ("cs_call_center_sk", "cc_call_center_sk"), ("cc_name",))
        keep = self._deviation(sums, sok, avg, aok, nonzero=False)
        cat, cok = self.decoded(keys[0])
        cols = {"i_category": (cat[keep], cok[keep]),
                "d_year": (keys[3][0][keep], keys[3][1][keep]),
                "d_moy": (keys[4][0][keep], keys[4][1][keep]),
                "avg_monthly_sales": (avg[keep], aok[keep]),
                "sum_sales": (sums[keep], sok[keep]),
                "__ord": (sums[keep] - avg[keep], sok[keep] & aok[keep])}
        return self.result(cols, [("__ord", True), ("i_category", True),
                                  ("d_year", True), ("d_moy", True)], 100,
                           hidden=("__ord",))

    def q44(self):
        np = self.np
        store, st_ok = self.col("store_sales", "ss_store_sk")
        idx = np.nonzero(st_ok & (store == 4))[0]
        items = self.take("store_sales", "ss_item_sk", idx)
        gid, n, first = self.group([items])
        avg, aok = self.gavg(gid, n, *self.take("store_sales",
                                                "ss_net_profit", idx))
        item_sk, iok = items[0][first], items[1][first]
        up = self.rank([], [(avg, aok, True)])
        down = self.rank([], [(avg, aok, False)])
        a, d = self.pairs(up, up < 11, down, down < 11)
        best, bhit = self.lookup("item", "i_item_sk", item_sk[a], iok[a])
        worst, whit = self.lookup("item", "i_item_sk", item_sk[d], iok[d])
        keep = bhit & whit
        desc, dok = self.col("item", "i_item_desc")
        cols = {"rnk": (up[a][keep], np.ones(int(keep.sum()), bool)),
                "best_performing": (desc[best[keep]], dok[best[keep]]),
                "worst_performing": (desc[worst[keep]], dok[worst[keep]])}
        return self.result(cols, [("rnk", True)], 100)

    def _cume_sales(self, fact, p):
        """q51's web_v1 / store_v1: per (item, month) sales and their
        running sum over the months of the item (ROWS frame)."""
        np = self.np
        _, item_ok = self.col(fact, f"{p}_item_sk")
        idx, dims = self.fact_dims(fact, [
            (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
             self.between("date_dim", "d_month_seq", 1176, 1187))],
            where=item_ok)
        keys = [self.take(fact, f"{p}_item_sk", idx),
                self.take("date_dim", "d_moy", dims["date_dim"])]
        gid, n, first = self.group(keys)
        sums, sok = self.gsum(gid, n, *self.take(fact, f"{p}_sales_price",
                                                 idx))
        (item, iok), (moy, mok) = [(v[first], ok[first]) for v, ok in keys]
        order = np.lexsort((np.where(mok, moy, 0), mok, np.where(iok, item, 0),
                            iok))
        cume = np.zeros(n)
        cnt = np.zeros(n, np.int64)
        si = item[order]
        starts = np.nonzero(np.r_[True, si[1:] != si[:-1]])[0]
        for lo, hi in zip(starts, np.r_[starts[1:], n]):
            rows = order[lo:hi]
            cume[rows] = np.cumsum(np.where(sok[rows], sums[rows], 0.0))
            cnt[rows] = np.cumsum(sok[rows])
        return item, iok, moy, mok, cume, cnt > 0

    def q51(self):
        np = self.np
        w_item, w_iok, w_moy, w_mok, w_cume, w_ok = self._cume_sales(
            "web_sales", "ws")
        s_item, s_iok, s_moy, s_mok, s_cume, s_ok = self._cume_sales(
            "store_sales", "ss")
        w, s = self.pairs(w_item * 16 + w_moy, w_iok & w_mok,
                          s_item * 16 + s_moy, s_iok & s_mok)
        keep = w_ok[w] & s_ok[s] & (w_cume[w] > s_cume[s])
        w, s = w[keep], s[keep]
        ones = np.ones(len(w), bool)
        cols = {"item_sk": (w_item[w], ones), "d_moy": (w_moy[w], ones),
                "web_sales": (w_cume[w], ones),
                "store_sales": (s_cume[s], ones)}
        return self.result(cols, [("item_sk", True), ("d_moy", True)], 100)

    # --- outer and keyless joins, set operations (NDS_JOINS_SETOPS) --------
    def _ticket_item(self, table, p):
        """(ticket, item) of a sales or returns table as one int64 key
        and its validity."""
        t, tok = self.col(table, f"{p}_ticket_number")
        i, iok = self.col(table, f"{p}_item_sk")
        return t * 4096 + i, tok & iok

    def _returns_act_sales(self, keep_return):
        """q93's inner select over store_sales LEFT JOIN store_returns:
        (store_sales row, store_returns row or -1) per output row, and
        act_sales. ``keep_return`` filters the returns side after the
        join (q93's JOIN reason), None keeps the outer join's rows."""
        np = self.np
        if "q93_pairs" not in self._cols:
            sk, sok = self._ticket_item("store_sales", "ss")
            rk, rok = self._ticket_item("store_returns", "sr")
            # the returns side searches the sales side: 2.88M binary
            # searches instead of 28.8M
            ri, li = self.pairs(rk, rok, sk, sok)
            self._cols["q93_pairs"] = li, ri
        li, ri = self._cols["q93_pairs"]
        hit = np.zeros(self.rows("store_sales"), bool)
        hit[li] = True
        lone = np.nonzero(~hit)[0]
        ss = np.concatenate([li, lone])
        sr = np.concatenate([ri, np.full(len(lone), -1)])
        if keep_return is not None:
            kept = (sr >= 0) & keep_return[np.maximum(sr, 0)]
            ss, sr = ss[kept], sr[kept]
        q, qok = self.take("store_sales", "ss_quantity", ss)
        price, pok = self.take("store_sales", "ss_sales_price", ss)
        rq, rqok = self.take("store_returns", "sr_return_quantity",
                             np.maximum(sr, 0))
        rqok = rqok & (sr >= 0)
        act = np.where(rqok, (q - rq) * price, q * price)
        return ss, sr, (act.astype(np.float64), qok & pok)

    def q93(self):
        np = self.np
        reason_ok = self.eq("reason", "r_reason_desc", "reason 3")
        rsk, rsok = self.col("store_returns", "sr_reason_sk")
        pos, found = self.lookup("reason", "r_reason_sk", rsk, rsok)
        ss, _, act = self._returns_act_sales(found & reason_ok[pos])
        key = self.take("store_sales", "ss_customer_sk", ss)
        gid, n, first = self.group([key])
        cols = self.keys_of([key], first, ["ss_customer_sk"])
        cols["sumsales"] = self.gsum(gid, n, *act)
        return self.result(cols, [("sumsales", True),
                                  ("ss_customer_sk", True)], 100)

    def q93_outer(self):
        """Q93_OUTER: q93's left outer join without its JOIN reason."""
        np = self.np
        ss, sr, act = self._returns_act_sales(None)
        key = self.take("store_sales", "ss_customer_sk", ss)
        gid, n, first = self.group([key])
        cols = self.keys_of([key], first, ["ss_customer_sk"])
        cols["sumsales"] = self.gsum(gid, n, *act)
        cols["n"] = (np.bincount(gid, minlength=n), np.ones(n, bool))
        cols["returned"] = (np.bincount(gid, weights=(sr >= 0).astype(
            np.float64), minlength=n).astype(np.int64), np.ones(n, bool))
        return self.result(cols, [("ss_customer_sk", True)])

    def _month_pairs(self, fact, p, cust):
        """Distinct non-null (customer, item) keys of ``fact`` rows sold
        in d_month_seq 1190-1200 (q97's CTEs; a NULL customer's pairs
        match nothing in the full outer join and count in no column)."""
        np = self.np
        idx, _ = self.fact_dims(fact, [
            (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
             self.between("date_dim", "d_month_seq", 1190, 1200))])
        c, cok = self.take(fact, cust, idx)
        i, iok = self.take(fact, f"{p}_item_sk", idx)
        return np.unique((c * 4096 + i)[cok & iok])

    def q97(self):
        np = self.np
        ssci = self._month_pairs("store_sales", "ss", "ss_customer_sk")
        csci = self._month_pairs("catalog_sales", "cs",
                                 "cs_bill_customer_sk")
        both = len(np.intersect1d(ssci, csci, assume_unique=True))
        one = np.ones(1, bool)
        return self.result({
            "store_only": (np.array([len(ssci) - both]), one),
            "catalog_only": (np.array([len(csci) - both]), one),
            "store_and_catalog": (np.array([both]), one)}, [], 100)

    def _list_price_bucket(self, q_lo, q_hi, lp, coupon):
        np = self.np
        keep = self.between("store_sales", "ss_quantity", q_lo, q_hi) & (
            self.between("store_sales", "ss_list_price", *lp)
            | self.between("store_sales", "ss_coupon_amt", *coupon))
        v, ok = self.col("store_sales", "ss_list_price")
        ok = keep & ok
        cnt = int(ok.sum())
        avg = float(v[ok].sum() / cnt) if cnt else 0.0
        return (np.array([avg]), np.array([cnt > 0])), \
            (np.array([cnt]), np.ones(1, bool))

    def q28(self):
        b1_lp, b1_cnt = self._list_price_bucket(0, 5, (10, 20), (0, 20))
        b2_lp, b2_cnt = self._list_price_bucket(6, 10, (30, 40), (10, 30))
        return self.result({"b1_lp": b1_lp, "b1_cnt": b1_cnt,
                            "b2_lp": b2_lp, "b2_cnt": b2_cnt}, [], 100)

    def _web_count(self, hour_lo, hour_hi):
        idx, _ = self.fact_dims("web_sales", [
            ("ws_sold_time_sk", "time_dim", "t_time_sk",
             self.between("time_dim", "t_hour", hour_lo, hour_hi)),
            ("ws_ship_hdemo_sk", "household_demographics", "hd_demo_sk",
             self.eq("household_demographics", "hd_dep_count", 6)),
            ("ws_web_page_sk", "web_page", "wp_web_page_sk",
             self.between("web_page", "wp_char_count", 2000, 6000))])
        return len(idx)

    def q90(self):
        np = self.np
        amc, pmc = self._web_count(8, 9), self._web_count(19, 20)
        if pmc == 0:
            return []
        return self.result({"am_pm_ratio": (np.array([amc * 1.0 / pmc]),
                                            np.ones(1, bool))}, [], 100)

    def _name_date_keys(self, fact, p, cust):
        """Distinct (c_last_name, c_first_name, d_date) of ``fact`` rows
        in d_month_seq 1176-1187 joined to their customer, as int64 keys
        of (name codes, date) with a NULL a value of its own."""
        np = self.np
        idx, dims = self.fact_dims(fact, [
            (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
             self.between("date_dim", "d_month_seq", 1176, 1187)),
            (cust, "customer", "c_customer_sk", None)])
        key = np.zeros(len(idx), np.int64)
        for dim, name in (("customer", "c_last_name"),
                          ("customer", "c_first_name"),
                          ("date_dim", "d_date")):
            codes, ok, uniq = self.dim_codes(dim, name, dims[dim])
            width = (len(uniq) if uniq is not None else 1 << 15) + 1
            key = key * width + np.where(ok, codes.astype(np.int64) + 1, 0)
        return np.unique(key)

    def _channel_name_dates(self):
        if "name_dates" not in self._cols:  # q38 and q87 share them
            self._cols["name_dates"] = [
                self._name_date_keys(f, p, c) for f, p, c in (
                    ("store_sales", "ss", "ss_customer_sk"),
                    ("catalog_sales", "cs", "cs_bill_customer_sk"),
                    ("web_sales", "ws", "ws_bill_customer_sk"))]
        return self._cols["name_dates"]

    def q38(self):
        np = self.np
        ss, cs, ws = self._channel_name_dates()
        cnt = len(np.intersect1d(np.intersect1d(ss, cs), ws))
        return self.result({"cnt": (np.array([cnt]), np.ones(1, bool))},
                           [], 100)

    def q87(self):
        np = self.np
        ss, cs, ws = self._channel_name_dates()
        cnt = len(np.setdiff1d(np.setdiff1d(ss, cs), ws))
        return self.result({"cnt": (np.array([cnt]), np.ones(1, bool))}, [])

    def q71(self):
        np = self.np
        keys, prices = [[], [], []], [[], []]
        for fact, p in (("web_sales", "ws"), ("store_sales", "ss")):
            idx, dims = self.fact_dims(fact, [
                (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
                 self.dates(d_moy=11, d_year=1999)),
                (f"{p}_item_sk", "item", "i_item_sk",
                 self.eq("item", "i_manager_id", 1)),
                (f"{p}_sold_time_sk", "time_dim", "t_time_sk",
                 self.isin("time_dim", "t_meal_time",
                           ("breakfast", "dinner")))])
            for k, (dim, c) in enumerate((("item", "i_brand_id"),
                                          ("item", "i_brand"),
                                          ("time_dim", "t_hour"))):
                keys[k].append(self.take(dim, c, dims[dim]))
            for k, v in enumerate(self.take(fact, f"{p}_ext_sales_price",
                                            idx)):
                prices[k].append(v)
        keys = [(np.concatenate([v for v, _ in kk]),
                 np.concatenate([ok for _, ok in kk])) for kk in keys]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["brand_id", "brand", "t_hour"])
        cols["ext_price"] = self.gsum(gid, n, np.concatenate(prices[0]),
                                      np.concatenate(prices[1]))
        return self.result(cols, [("ext_price", False), ("brand_id", True),
                                  ("t_hour", True)], 100)

    def q33(self):
        np = self.np
        mids, sums = [], []
        for fact, p in (("store_sales", "ss"), ("catalog_sales", "cs"),
                        ("web_sales", "ws")):
            idx, dims = self.fact_dims(fact, [
                (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
                 self.dates(d_year=1998, d_moy=5)),
                (f"{p}_item_sk", "item", "i_item_sk",
                 self.eq("item", "i_category", "Electronics"))])
            key = self.take("item", "i_manufact_id", dims["item"])
            gid, n, first = self.group([key])
            mids.append(self.keys_of([key], first, ["m"])["m"])
            sums.append(self.gsum(gid, n, *self.take(
                fact, f"{p}_ext_sales_price", idx)))
        key = (np.concatenate([v for v, _ in mids]),
               np.concatenate([ok for _, ok in mids]))
        gid, n, first = self.group([key])
        cols = self.keys_of([key], first, ["i_manufact_id"])
        cols["total_sales"] = self.gsum(
            gid, n, np.concatenate([v for v, _ in sums]),
            np.concatenate([ok for _, ok in sums]))
        return self.result(cols, [("total_sales", True),
                                  ("i_manufact_id", True)], 100)


    # --- subquery predicates, ROLLUP, round and stddev (phase 6c) -------------
    def _customer_set(self, fact, p, cust, year, moy_lo, moy_hi):
        """The non-null customer keys of ``fact`` rows sold in ``year``
        between the two months (an EXISTS / IN subquery's rows)."""
        np = self.np
        idx, _ = self.fact_dims(fact, [
            (f"{p}_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=year)
             & self.between("date_dim", "d_moy", moy_lo, moy_hi))])
        c, cok = self.take(fact, cust, idx)
        return np.unique(c[cok])

    def _demo_counts(self, keep_customer, counts):
        """q10 / q69: kept customers joined to their demographics, grouped
        by four demographic columns, ordered by them, LIMIT 100; the
        SELECT list is ``[gender, marital, education] + counts[:1] +
        [purchase_estimate] + counts[1:]``, each count a COUNT(*)."""
        np = self.np
        cust = np.nonzero(keep_customer)[0]
        demo, hit = self.lookup("customer_demographics", "cd_demo_sk",
                                *self.take("customer", "c_current_cdemo_sk",
                                           cust))
        names = ["cd_gender", "cd_marital_status", "cd_education_status",
                 "cd_purchase_estimate"]
        keys = [self.take("customer_demographics", c, demo[hit])
                for c in names]
        gid, n, first = self.group(keys)
        key_cols = self.keys_of(keys, first, names)
        cnt = (np.bincount(gid, minlength=n), np.ones(n, bool))
        select = names[:3] + counts[:1] + names[3:] + counts[1:]
        cols = {c: cnt if c in counts else key_cols[c] for c in select}
        return self.result(cols, [(c, True) for c in names], 100)

    def _customers_at(self, addr_keep):
        """Customers whose current address passes ``addr_keep``."""
        addr, hit = self.lookup("customer_address", "ca_address_sk",
                                *self.col("customer", "c_current_addr_sk"))
        return hit & addr_keep[addr]

    def _q10(self, counties):
        np = self.np
        keep = np.ones(self.rows("customer_address"), bool) \
            if counties is None else \
            self.isin("customer_address", "ca_county", counties)
        c, cok = self.col("customer", "c_customer_sk")
        in_ss = np.isin(c, self._customer_set(
            "store_sales", "ss", "ss_customer_sk", 1999, 1, 8))
        in_ws = np.isin(c, self._customer_set(
            "web_sales", "ws", "ws_bill_customer_sk", 1999, 1, 8))
        in_cs = np.isin(c, self._customer_set(
            "catalog_sales", "cs", "cs_bill_customer_sk", 1999, 1, 8))
        kept = self._customers_at(keep) & cok & in_ss & (in_ws | in_cs)
        return self._demo_counts(kept, ["cnt1", "cnt2"])

    def q10(self):
        return self._q10(("county1", "county2", "county3"))

    def q10_or(self):
        return self._q10(None)

    def q69(self):
        np = self.np
        c, cok = self.col("customer", "c_customer_sk")
        in_ss = np.isin(c, self._customer_set(
            "store_sales", "ss", "ss_customer_sk", 1999, 1, 3))
        in_ws = np.isin(c, self._customer_set(
            "web_sales", "ws", "ws_bill_customer_sk", 1999, 1, 3))
        keep = self._customers_at(self.isin(
            "customer_address", "ca_state", ("KY", "GA", "NM", "TX")))
        return self._demo_counts(keep & cok & in_ss & ~in_ws, ["cnt1"])

    def q6(self):
        np = self.np
        month, mok = self.col("date_dim", "d_month_seq")
        first = self.dates(d_year=1999, d_moy=1) & mok
        if not first.any():
            return []
        cat = self.col("item", "i_category")
        price, pok = self.col("item", "i_current_price")
        gid, n, _ = self.group([cat])
        avg, aok = self.gavg(gid, n, price, pok)
        # the correlated AVG: no match (a NULL category) or no price is
        # NULL, and the comparison filters the item out
        item_keep = pok & cat[1] & aok[gid] & (price > 1.2 * avg[gid])
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             mok & (month == month[first].min())),
            ("ss_item_sk", "item", "i_item_sk", item_keep),
            ("ss_customer_sk", "customer", "c_customer_sk", None)])
        addr, hit = self.lookup("customer_address", "ca_address_sk",
                                *self.take("customer", "c_current_addr_sk",
                                           dims["customer"]))
        keys = [self.take("customer_address", "ca_state", addr[hit])]
        gid, n, first_row = self.group(keys)
        cols = self.keys_of(keys, first_row, ["state"])
        cnt = np.bincount(gid, minlength=n)
        cols["cnt"] = (cnt, np.ones(n, bool))
        having = cnt >= 10
        cols = {k: (v[having], ok[having]) for k, (v, ok) in cols.items()}
        return self.result(cols, [("cnt", True), ("state", True)], 100)

    def q94(self):
        np = self.np
        idx, _ = self.fact_dims("web_sales", [
            ("ws_ship_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1999)
             & self.between("date_dim", "d_moy", 2, 3)),
            ("ws_web_site_sk", "web_site", "web_site_sk", None)])
        order, ook = self.col("web_sales", "ws_order_number")
        wh, wok = self.col("web_sales", "ws_warehouse_sk")
        # EXISTS another row of the order from another warehouse: the
        # order has two or more distinct non-null warehouses (the row's
        # own warehouse among them), and the row's warehouse is not NULL
        both = ook & wok
        pairs = np.unique(order[both] * 64 + wh[both])
        orders, n_wh = np.unique(pairs // 64, return_counts=True)
        multi = orders[n_wh >= 2]
        ret, rok = self.col("web_returns", "wr_order_number")
        o, ok_o = order[idx], ook[idx]
        keep = ok_o & wok[idx] & np.isin(o, multi) & \
            ~np.isin(o, ret[rok])
        idx = idx[keep]
        out = {"order_count": len(np.unique(order[idx]))}
        for name, c in (("total_shipping_cost", "ws_ext_ship_cost"),
                        ("total_net_profit", "ws_net_profit")):
            v, ok = self.take("web_sales", c, idx)
            out[name] = float(v[ok].sum()) if ok.any() else None
        return [out]

    def q45(self):
        np = self.np
        idx, dims = self.fact_dims("web_sales", [
            ("ws_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_qoy=2, d_year=1999)),
            ("ws_item_sk", "item", "i_item_sk", None),
            ("ws_bill_customer_sk", "customer", "c_customer_sk", None)])
        addr, hit = self.lookup("customer_address", "ca_address_sk",
                                *self.take("customer", "c_current_addr_sk",
                                           dims["customer"]))
        zips = {"85669", "86197", "88274", "83405", "86475"}
        zip_v, zip_ok = self.col("customer_address", "ca_zip")
        zip_in = zip_ok & np.fromiter((z[:5] in zips for z in zip_v), bool,
                                      len(zip_v))
        item_in = self.isin("item", "i_manufact_id", (7, 11, 13))
        keep = hit & (zip_in[addr] | item_in[dims["item"]])
        idx, addr = idx[keep], addr[keep]
        keys = [self.take("customer_address", c, addr)
                for c in ("ca_zip", "ca_city")]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, ["ca_zip", "ca_city"])
        cols["sum_sales"] = self.gsum(
            gid, n, *self.take("web_sales", "ws_sales_price", idx))
        return self.result(cols, [("ca_zip", True), ("ca_city", True)], 100)

    def _rollup(self, keys, names, rows_agg):
        """ROLLUP over ``keys`` ([(values, valid)] at the kept rows):
        for each prefix length, longest first, the groups of that prefix
        with the later keys NULL; ``rows_agg(gid, n)`` gives each group's
        aggregate columns. Returns {name: (values, valid)} plus
        ``__level``, the number of keys rolled up."""
        np = self.np
        rows = len(keys[0][0])
        parts = []
        for k in range(len(keys), -1, -1):
            # the empty grouping set: one group over a constant key, none
            # over no row
            gid, n, first = self.group(keys[:k] or [
                (np.zeros(rows, np.int64), np.ones(rows, bool))])
            part = {}
            for i, (name, (values, ok)) in enumerate(zip(names, keys)):
                part[name] = (values[first], ok[first] & (i < k))
            part.update(rows_agg(gid, n))
            part["__level"] = (np.full(n, len(keys) - k), np.ones(n, bool))
            parts.append(part)
        return {c: (np.concatenate([p[c][0] for p in parts]),
                    np.concatenate([p[c][1] for p in parts]))
                for c in parts[0]}

    def q27(self):
        np = self.np
        idx, dims = self.fact_dims("store_sales", [
            ("ss_cdemo_sk", "customer_demographics", "cd_demo_sk",
             self.eq("customer_demographics", "cd_gender", "F")
             & self.eq("customer_demographics", "cd_marital_status", "W")
             & self.eq("customer_demographics", "cd_education_status",
                       "Primary")),
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1998)),
            ("ss_store_sk", "store", "s_store_sk",
             self.eq("store", "s_state", "TN")),
            ("ss_item_sk", "item", "i_item_sk", None)])
        keys = [self.take("item", "i_item_id", dims["item"]),
                self.take("store", "s_state", dims["store"])]
        aggs = [("agg1", "ss_quantity"), ("agg2", "ss_list_price"),
                ("agg3", "ss_coupon_amt"), ("agg4", "ss_sales_price")]
        vals = {name: self.take("store_sales", c, idx) for name, c in aggs}

        def rows_agg(gid, n):
            return {name: self.gavg(gid, n, *vals[name]) for name, _ in aggs}
        cols = self._rollup(keys, ["i_item_id", "s_state"], rows_agg)
        level = cols.pop("__level")[0]
        out = {"i_item_id": cols["i_item_id"], "s_state": cols["s_state"],
               "g_state": ((level >= 1).astype(np.int64),
                           np.ones(len(level), bool))}
        out.update({name: cols[name] for name, _ in aggs})
        # NULLS LAST on both keys: the result's order puts NULL first
        # for ascending keys, so order by (is null, value) here
        for name in ("i_item_id", "s_state"):
            out[f"__null_{name}"] = ((~out[name][1]).astype(np.int64),
                                     np.ones(len(level), bool))
        return self.result(out, [("__null_i_item_id", True),
                                 ("i_item_id", True),
                                 ("__null_s_state", True),
                                 ("s_state", True)], 100,
                           hidden=("__null_i_item_id", "__null_s_state"))

    def q36(self):
        np = self.np
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_year=1998)),
            ("ss_store_sk", "store", "s_store_sk",
             self.eq("store", "s_state", "TN")),
            ("ss_item_sk", "item", "i_item_sk", None)])
        keys = [self.dim_codes("item", "i_category", dims["item"]),
                self.dim_codes("item", "i_class", dims["item"])]
        profit = self.take("store_sales", "ss_net_profit", idx)
        sales = self.take("store_sales", "ss_ext_sales_price", idx)

        def rows_agg(gid, n):
            p, pok = self.gsum(gid, n, *profit)
            s, sok = self.gsum(gid, n, *sales)
            ok = pok & sok & (s != 0)
            return {"gross_margin": (p / np.where(ok, s, 1.0), ok)}
        cols = self._rollup([(c, ok) for c, ok, _ in keys],
                            ["i_category", "i_class"], rows_agg)
        level, _ = cols.pop("__level")
        n = len(level)
        cat, cat_ok = cols["i_category"]
        # the parent: the rollup level, and the category for the rows
        # grouped by class (GROUPING(i_class) = 0)
        parent = [(level, np.ones(n, bool)), (cat, cat_ok & (level == 0))]
        margin, mok = cols["gross_margin"]
        rank = self.rank(parent, [(margin, mok, True)])
        out = {"gross_margin": cols["gross_margin"],
               "i_category": (keys[0][2][cat], cat_ok),
               "i_class": (keys[1][2][cols["i_class"][0]],
                           cols["i_class"][1]),
               "lochierarchy": (level, np.ones(n, bool)),
               "rank_within_parent": (rank, np.ones(n, bool)),
               "__null_cat": ((~cat_ok).astype(np.int64), np.ones(n, bool)),
               "__cat": (cat, cat_ok)}
        return self.result(out, [("lochierarchy", False),
                                 ("__null_cat", True), ("__cat", True),
                                 ("rank_within_parent", True)], 100,
                           hidden=("__null_cat", "__cat"))

    def q17_join_rows(self):
        """Rows q17's join of store_sales, store_returns and
        catalog_sales on (customer, item) holds before its date filter:
        the product of the three tables' counts per key, summed."""
        np = self.np

        def counts(table, cust, item):
            c, cok = self.col(table, cust)
            i, iok = self.col(table, item)
            ok = cok & iok
            return np.unique(c[ok] * 4096 + i[ok], return_counts=True)
        k1, n1 = counts("store_sales", "ss_customer_sk", "ss_item_sk")
        k2, n2 = counts("store_returns", "sr_customer_sk", "sr_item_sk")
        k3, n3 = counts("catalog_sales", "cs_bill_customer_sk", "cs_item_sk")
        k12, i1, i2 = np.intersect1d(k1, k2, return_indices=True)
        _, j, i3 = np.intersect1d(k12, k3, return_indices=True)
        return int((n1[i1][j] * n2[i2][j] * n3[i3]).sum())

    def q17(self):
        np = self.np
        idx, dims = self.fact_dims("store_sales", [
            ("ss_sold_date_sk", "date_dim", "d_date_sk",
             self.dates(d_qoy=1, d_year=1998)),
            ("ss_item_sk", "item", "i_item_sk", None),
            ("ss_store_sk", "store", "s_store_sk", None)])

        def ci(table, cust, item, rows=None):
            c, cok = self.col(table, cust)
            i, iok = self.col(table, item)
            key, ok = c * 4096 + i, cok & iok
            return (key, ok) if rows is None else (key[rows], ok[rows])
        # store_sales x store_returns on (customer, item), then x
        # catalog_sales on the returns' (customer, item)
        li, ri = self.pairs(*ci("store_sales", "ss_customer_sk",
                                "ss_item_sk", idx),
                            *ci("store_returns", "sr_customer_sk",
                                "sr_item_sk"))
        rk, rok = ci("store_returns", "sr_customer_sk", "sr_item_sk", ri)
        ck, cok = ci("catalog_sales", "cs_bill_customer_sk", "cs_item_sk")
        mi, ci_rows = self.pairs(rk, rok, ck, cok)
        ss, sr = idx[li[mi]], ri[mi]
        item, store = dims["item"][li[mi]], dims["store"][li[mi]]
        names = [("i_item_id", "item", item), ("i_item_desc", "item", item),
                 ("s_state", "store", store)]
        keys = [self.take(t, c, rows) for c, t, rows in names]
        gid, n, first = self.group(keys)
        cols = self.keys_of(keys, first, [c for c, _, _ in names])
        q, qok = self.take("store_sales", "ss_quantity", ss)
        rq = self.take("store_returns", "sr_return_quantity", sr)
        cq = self.take("catalog_sales", "cs_quantity", ci_rows)
        cnt = np.bincount(gid, weights=qok.astype(np.float64), minlength=n)
        cols["store_sales_quantitycount"] = (cnt.astype(np.int64),
                                             np.ones(n, bool))
        mean, mok = self.gavg(gid, n, q, qok)
        cols["store_sales_quantityave"] = (mean, mok)
        dev = np.where(qok, q - mean[gid], 0.0)
        m2 = np.bincount(gid, weights=dev * dev, minlength=n)
        sd_ok = cnt > 1
        cols["store_sales_quantitystdev"] = (
            np.sqrt(m2 / np.where(sd_ok, cnt - 1, 1.0)), sd_ok)
        for label, (v, ok) in (("sr_quantity", rq), ("catalog_sales_quantity",
                                                     cq)):
            cols[f"{label}count"] = (np.bincount(
                gid, weights=ok.astype(np.float64),
                minlength=n).astype(np.int64), np.ones(n, bool))
            cols[f"{label}ave"] = self.gavg(gid, n, v, ok)
        return self.result(cols, [(c, True) for c, _, _ in names], 100)

    def q2(self):
        from decimal import ROUND_HALF_UP, Decimal
        np = self.np
        week = {name: (np.zeros(105), np.zeros(105, np.int64))
                for name in ("Sunday", "Monday")}
        present = np.zeros(105, bool)  # weeks with any sale
        for fact, p in (("catalog_sales", "cs"), ("web_sales", "ws")):
            idx, dims = self.fact_dims(fact, [
                (f"{p}_sold_date_sk", "date_dim", "d_date_sk", None)])
            w = self.take("date_dim", "d_week_seq", dims["date_dim"])[0]
            present[np.unique(w) - 5100] = True
            day, day_ok = self.take("date_dim", "d_day_name",
                                    dims["date_dim"])
            price, pok = self.take(fact, f"{p}_ext_sales_price", idx)
            for name, (s, c) in week.items():
                hit = day_ok & (day == name) & pok
                s += np.bincount(w[hit] - 5100, weights=price[hit],
                                 minlength=105)
                c += np.bincount(w[hit] - 5100, minlength=105)

        def ratio(name, y, z):
            s, c = week[name]
            if not (c[y] and c[z]) or s[z] == 0:
                return None
            r = Decimal(repr(float(s[y] / s[z]))).quantize(
                Decimal("0.01"), rounding=ROUND_HALF_UP)
            return float(r)
        out = []
        for y in range(105 - 52):
            if present[y] and present[y + 52]:
                out.append({"d_week_seq1": 5100 + y,
                            "r1": ratio("Sunday", y, y + 52),
                            "r2": ratio("Monday", y, y + 52)})
        return out[:100]


def same_rows(got, ref):
    """Rows equal, floats within RTOL."""
    if len(got) != len(ref):
        return False
    for g, r in zip(got, ref):
        if g.keys() != r.keys():
            return False
        for k, v in r.items():
            if isinstance(v, float):
                if not abs(g[k] - v) <= RTOL * abs(v):
                    return False
            elif g[k] != v:
                return False
    return True


def check_held(hold, counts, label):
    """Every B1 / B3 launch the counters saw went through ``hold``
    (``holding_launches``): held against the plain version on its own
    inputs."""
    check(hold.held["tile_reduce"] == counts["tile_reduce"] and
          hold.held["tile_group_reduce"] == counts["tile_group_reduce"],
          f"{label}: held {hold.held}, launched {counts}")
    if counts["tile_reduce"] or counts["tile_group_reduce"]:
        log(f"{label}: B1 {hold.held['tile_reduce']} / B3 "
            f"{hold.held['tile_group_reduce']} launches held against the "
            f"plain versions (max_abs_err {hold.err})")


class executions_of:
    """Records every plan ``session`` executes inside the block (a query
    and the subqueries its analysis runs): [(physical plan, its
    ExecContext, the kernel launches during it)]."""

    def __init__(self, session, read_counts):
        self.session, self.read_counts = session, read_counts
        self.runs = []

    def __enter__(self):
        session, orig = self.session, self.session.execute

        def execute(plan):
            before = self.read_counts()
            out = orig(plan)
            after = self.read_counts()
            self.runs.append((*session._last_execution,
                              {k: after[k] - before[k] for k in after}))
            return out
        session.execute = execute
        return self.runs

    def __exit__(self, *exc):
        del self.session.execute


class references_ahead:
    """numpy references computed on one host thread, in the order the
    queries will ask for them, while the card runs the queries before
    them: ``get(q)`` waits for q's. numpy's heavy operations release
    the interpreter lock, so the references mostly overlap the queries'
    walls (which they share the host with)."""

    def __init__(self, fns):
        from concurrent.futures import ThreadPoolExecutor
        self.pool = ThreadPoolExecutor(1)
        self.futures = {q: self.pool.submit(fn) for q, fn in fns
                        if fn is not None}

    def get(self, q):
        return self.futures.pop(q).result()

    def close(self):
        for f in self.futures.values():
            f.cancel()
        self.pool.shutdown(wait=True)


class HostWorker:
    """``target(conn, *args)`` (``host_worker`` unless named) in a second
    process, spawned (it shares no CUDA state and no interpreter lock
    with the smoke): it sends its results one by one, and ``get(key)``
    waits for one. A daemon, so that the interpreter's exit stops it if
    ``close`` is never reached."""

    def __init__(self, *args, target=None):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=target or host_worker,
                                args=(child, *args), daemon=True)
        self.proc.start()
        child.close()
        self.got = {}

    def get(self, key, timeout=900):
        while key not in self.got:
            check(self.conn.poll(timeout), f"host worker: no {key} in "
                  f"{timeout} s")
            got, value = self.conn.recv()
            check(got != "error", f"host worker failed:\n{value}")
            self.got[got] = value
        return self.got.pop(key)

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.conn.close()


def run_nds(torch, dev, read_counts, session, q, text, ref, want_fn, warm,
            widest):
    """One NDS text through ``session.sql`` on the card: a first run and
    ``warm`` warm runs, each held against ``want_fn()`` (the numpy
    rows; with None, each warm run is held against the first run), with
    the launch counts equal in every run and B3 held against its plain
    version on every batch it took; ``widest[0]`` keeps the widest batch
    B3 took. ``want_fn`` may be a ``references_ahead``'s getter of the
    query. Returns the query's numbers."""
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.testing import compare_rows, order_keys
    t = time.perf_counter()
    want = want_fn() if want_fn is not None else None
    ref_s = time.perf_counter() - t
    facts = sum(ref.rows(f) for f in NDS_FACTS
                if re.search(rf"\b{f}\b", text))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    DK.reset_counts()
    with executions_of(session, read_counts) as executions, \
            holding_launches(torch, DK) as hold:
        t = time.perf_counter()
        df = session.sql(text)  # runs the plan-time subqueries
        torch.cuda.synchronize()
        analysis = time.perf_counter() - t
        rows = df.collect()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
    counts = read_counts()
    check_held(hold, counts, f"nds {q}")
    pb = sum(ctx.metric_totals().get("pallasBatches", 0)
             for _, ctx, _ in executions)
    keys, limit = order_keys(text, df.columns)
    held = "numpy"
    if want is None:
        want, held = rows, "its first run"
    else:
        diff = compare_rows(rows, want, keys, limit, RTOL)
        check(diff is None, f"nds {q}: {diff} (numpy reference)")
    walls = []
    for _ in range(warm):
        DK.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows = session.sql(text).collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        check(compare_rows(rows, want, keys, limit, RTOL) is None,
              f"nds {q}: a warm run disagrees with {held}")
        check(read_counts() == counts,
              f"nds {q}: a warm run launched {read_counts()}, the "
              f"first {counts}")
    wall = statistics.median(walls) if walls else first
    physical, ctx = session._last_execution
    self_ms = sorted(operator_self_ms(physical, ctx.metrics, {}).items(),
                     key=lambda kv: -kv[1])
    b3_err, b1_err = hold.err["tile_group_reduce"], hold.err["tile_reduce"]
    if hold.widest is not None and (widest[0] is None or
                                    hold.widest[0] > widest[0][0]):
        widest[0] = hold.widest + (q,)
    del hold
    out = {"first_s": first, "analysis_s": analysis, "warm_s": wall,
           "b3_max_abs_err": b3_err,
           "b1_max_abs_err": b1_err, "warm_runs_s": walls,
           "fact_rows": facts,
           "fact_rows_per_s": facts / wall, "result_rows": len(rows),
           "launches": counts, "pallas_batches": pb,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "reference_s": ref_s}
    log(f"nds {q}: matches {held} ({len(rows)} rows); first (B1 / B3 "
        f"held on every launch) {first:.4f} s, {warm_note(walls)}; "
        f"{facts} fact rows, "
        f"{facts / wall:.4e} rows/s; launches {counts}, pallasBatches "
        f"{pb}; max_memory_allocated {out['peak_gb']:.3f} GB; numpy "
        f"{ref_s:.1f} s")
    twice = " (both join sides run twice under the full outer join: " \
        "their operators' times hold both runs)" \
        if shares_subtrees(physical) else ""
    log(f"nds {q} operator self time (host clock, ms, last run)"
        f"{twice}: " + ", ".join(f"{k} {v:.1f}" for k, v in self_ms[:5]))
    return out


def nds_batches_ahead():
    """The NDS tables' host batches at NDS_Q82_ROWS and NDS_ROWS
    (``nds_host_batches``), made on a host thread from the call on:
    ``get(scale)`` waits for a scale's, in that order."""
    from spark_rapids_tpu_torch.models.nds import nds_host_batches

    def make(scale):
        t = time.perf_counter()
        return nds_host_batches(scale, BATCH_ROWS), time.perf_counter() - t
    return references_ahead([(scale, lambda scale=scale: make(scale))
                             for scale in (NDS_Q82_ROWS, NDS_ROWS)])


def nds_phase(torch, np, dev, read_counts, tables_ahead):
    """The NDS slice through ``session.sql`` on the card, each run held
    against NdsNumpy, over the tables ``tables_ahead``
    (``nds_batches_ahead``) made; returns ({query: numbers}, the SF10
    session, its reference, the widest batch B3 took, and the joins
    phase's numpy references, started on a host thread of their own once
    the SF10 tables exist)."""
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models.nds import (NDS_QUERIES, NDS_SLICE,
                                                   NDS_WINDOW, register_nds)
    from spark_rapids_tpu_torch.plan.session import TpuSession

    def load(scale):
        session = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS}),
                             device=dev)
        host = {}
        t = time.perf_counter()
        batches, gen_s = tables_ahead.get(scale)
        waited = time.perf_counter() - t
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        register_nds(session, scale, host_tables=host, batches=batches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        nbytes = torch.cuda.memory_allocated(dev) - before
        log(f"nds data, scale_rows {scale}: " + ", ".join(
            f"{n} {t.num_rows}" for n, t in host.items()
            if n in NDS_FACTS) + f"; {sum(t.num_rows for t in host.values())}"
            f" rows in {len(host)} tables, {nbytes / 1e9:.3f} GB on the "
            f"card; generated in {gen_s:.1f} s on a host thread (waited "
            f"{waited:.1f} s), moved in {secs:.1f} s")
        return session, NdsNumpy(np, host)

    def run(q, session, ref, ahead=None):
        want = (lambda: ahead.get(q)) if ahead is not None \
            else getattr(ref, q)
        return run_nds(torch, dev, read_counts, session, q, NDS_QUERIES[q],
                       ref, want, WARM_RUNS, widest)

    # q82 first, alone on the card with its SF1 tables: its join output
    # and grouping take more than the SF10 tables leave free
    report = {}
    widest = [None]  # the widest batch B3 took: (rows, groups, gid, lanes, q)
    small, small_ref = load(NDS_Q82_ROWS)
    q82 = run("q82", small, small_ref)
    q82["join_rows"] = small_ref.q82_join_rows()[1]
    log(f"nds q82 at scale_rows {NDS_Q82_ROWS} joins {q82['join_rows']} "
        "rows before its GROUP BY")
    # the session's plans hold reference cycles: collect them now, so
    # the SF1 tables are gone before the SF10 tables are measured
    del small, small_ref
    gc.collect()
    torch.cuda.empty_cache()
    session, ref = load(NDS_ROWS)
    items, big = ref.q82_join_rows()
    log(f"nds q82 at scale_rows {NDS_ROWS} would join {big} rows ({items} "
        f"items kept) before its GROUP BY: it runs at {NDS_Q82_ROWS}")
    joins_ahead = references_ahead(joins_references(ref))
    order = [q for q in NDS_SLICE + NDS_WINDOW if q != "q82"]
    ahead = references_ahead([(q, getattr(ref, q)) for q in order])
    try:
        for q in NDS_SLICE:
            report[q] = q82 if q == "q82" else run(q, session, ref, ahead)
        for q in NDS_WINDOW:
            report[q] = run(q, session, ref, ahead)
    except BaseException:
        joins_ahead.close()
        raise
    finally:
        ahead.close()
    for q in NDS_B3_QUERIES:
        check(report[q]["launches"]["tile_group_reduce"] > 0
              and report[q]["pallas_batches"] > 0,
              f"nds {q}: the grouped kernel (B3) did not run")
    log("nds summary " + json.dumps({q: {
        k: r[k] for k in ("first_s", "warm_s", "fact_rows_per_s",
                          "result_rows", "pallas_batches", "peak_gb")}
        | {"b3": r["launches"]["tile_group_reduce"],
           "b1": r["launches"]["tile_reduce"]}
        for q, r in report.items()}))
    return report, session, ref, widest[0], joins_ahead


def cross_check(torch, dev, read_counts, queries, scale, held=None):
    """Each query (a name of NDS_QUERIES, or a (name, text) pair) at
    ``scale`` on the card and on the CPU (the plain
    versions, which tests/test_torch_nds.py holds against the JAX
    package): the card's rows must equal the CPU's, or, for a query in
    ``held``, pass ``held[q](card rows, CPU session)`` (which returns what
    differs, or None). That checks the CUDA path, not the semantics. B1
    and B3 are held against their plain versions on every batch they
    take. Returns {query: result rows}."""
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models.nds import NDS_QUERIES, register_nds
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.session import TpuSession
    from spark_rapids_tpu_torch.testing import compare_rows, order_keys
    conf = SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS})
    t = time.perf_counter()
    card, cpu = TpuSession(conf, device=dev), TpuSession(conf, device="cpu")
    register_nds(card, scale)
    register_nds(cpu, scale)
    log(f"nds tables at scale_rows {scale} on the card and on the CPU in "
        f"{time.perf_counter() - t:.1f} s")
    out = {}
    for q in queries:
        q, text = (q, NDS_QUERIES[q]) if isinstance(q, str) else q
        DK.reset_counts()
        with holding_launches(torch, DK) as hold:
            df = card.sql(text)
            rows = df.collect()
        counts = read_counts()
        check_held(hold, counts, f"nds {q} at {scale}")
        t = time.perf_counter()
        if held and q in held:
            diff = held[q](rows, cpu)
        else:
            diff = compare_rows(rows, cpu.sql(text).collect(),
                                *order_keys(text, df.columns), RTOL)
        cpu_s = time.perf_counter() - t
        check(diff is None, f"nds {q} at scale_rows {scale}: {diff} (the "
              "port's CPU run)")
        out[q] = len(rows)
        how = " with ties left open" if held and q in held else ""
        log(f"nds {q} at scale_rows {scale}: the card's {len(rows)} rows "
            f"match the port's CPU run{how} ({cpu_s:.1f} s; this checks "
            f"the CUDA path, not the semantics); launches {counts}")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def q67_ties_diff(got, rollup, top=10, limit=100):
    """What differs between q67's rows and the ROLLUP sums ``rollup``
    (Q67_ROLLUP's rows) that its RANK reads, with ties left open: sums
    within RTOL of each other count as tied, so a row's rank may be
    anything from 1 + the number of larger sums in its category to that
    plus the number of sums tied with it. Each row must be a row of
    ``rollup`` with its sum, and its rank in that range and at most
    ``top``; the rows in ORDER BY order; and every row that ranks within
    ``top`` however the ties break present where it sorts before the
    last row (everywhere, when there are fewer than ``limit`` rows).
    None when nothing differs."""
    import bisect
    from collections import defaultdict

    from spark_rapids_tpu_torch.testing import values_equal
    keys = ("i_category", "i_class", "i_brand", "s_store_id")

    def num(v):  # RANK ... DESC puts a NULL sum last
        return float("-inf") if v is None else float(v)

    def tol(v):
        return RTOL * abs(v) if math.isfinite(v) else 0.0

    def order(r):  # ORDER BY the keys NULLS LAST
        return tuple((r[k] is None, r[k] or "") for k in keys)

    sums = defaultdict(list)  # category -> its sums, ascending
    for r in rollup:
        sums[r["i_category"]].append(num(r["sumsales"]))
    for v in sums.values():
        v.sort()

    def rank_range(r):
        v, s = sums[r["i_category"]], num(r["sumsales"])
        above = len(v) - bisect.bisect_right(v, s + tol(s))
        tied = bisect.bisect_right(v, s + tol(s)) - \
            bisect.bisect_left(v, s - tol(s))
        return 1 + above, above + tied

    by_key = defaultdict(list)
    for r in rollup:
        by_key[order(r)].append(r)

    def match(r):
        return next((w for w in by_key[order(r)] if values_equal(
            r["sumsales"], w["sumsales"], RTOL)), None)

    prev = None
    for r in got:
        w = match(r)
        if w is None:
            return f"row {r} is no ROLLUP row of the CPU run"
        lo, hi = rank_range(w)
        if not lo <= r["rk"] <= min(hi, top):
            return f"row {r} ranks {r['rk']}, ties allow {lo}-{hi}"
        if prev is not None and (order(r), r["rk"]) < prev:
            return "rows are not in ORDER BY order"
        prev = (order(r), r["rk"])
    seen = {(order(r), num(r["sumsales"])) for r in got}
    last = order(got[-1]) if got else None
    for w in rollup:
        if rank_range(w)[1] > top or (len(got) == limit and
                                      order(w) >= last):
            continue
        if not any(k == order(w) and values_equal(s, num(w["sumsales"]),
                                                  RTOL) for k, s in seen):
            return f"row {w} ranks within {top} however ties break, " \
                "and is missing"
    return None


def seg_sum_timing(torch, dev, session):
    """The float group sums of every device (expr/aggregates.py _seg_sum:
    a segmented scan over rows in group order) against ``index_add_``
    (its atomics add in an order that varies between runs), each on the
    inputs of the widest float _seg_sum call that a SEG_SUM_QUERIES query
    makes at SF10, and the stable sort of the group ids that the
    hash-claim path pays once per batch to hand its rows over in group
    order (ops/kernels.py _in_group_order). Returns {query: numbers}."""
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.models.nds import NDS_QUERIES
    real, out = Agg._seg_sum, {}
    for q in SEG_SUM_QUERIES:
        seen = {"calls": 0, "widest": None}

        def spy(values, gid, num_groups, dtype=None):
            res = real(values, gid, num_groups, dtype)
            if res.is_floating_point():
                seen["calls"] += 1
                w = seen["widest"]
                if w is None or values.shape[0] > w[0].shape[0]:
                    seen["widest"] = (values.to(res.dtype).clone(),
                                      gid.clone(), num_groups)
            return res
        Agg._seg_sum = spy
        try:
            session.sql(NDS_QUERIES[q]).collect()
        finally:
            Agg._seg_sum = real
        values, gid, slots = seen["widest"]

        def added():
            return torch.zeros(slots, dtype=values.dtype,
                               device=dev).index_add_(0, gid, values)
        ordered, plain = real(values, gid, slots), added()
        scale = float(values.abs().sum())
        check(torch.allclose(ordered, plain, rtol=RTOL, atol=RTOL * scale),
              f"{q}: the ordered group sums disagree with index_add_")
        r = {"rows": values.shape[0],
             "groups": int(torch.unique_consecutive(gid).numel()),
             "float_calls": seen["calls"],
             "ms": device_ms(torch, lambda: real(values, gid, slots)),
             "index_add_ms": device_ms(torch, added),
             "sort_ms": device_ms(torch, lambda: torch.sort(gid,
                                                            stable=True)),
             "runs_bit_equal": all(torch.equal(ordered, real(
                 values, gid, slots)) for _ in range(5)),
             "index_add_runs_bit_equal": all(torch.equal(plain, added())
                                             for _ in range(5))}
        out[q] = r
        log(f"group sums[{q} widest, {r['rows']} rows, {r['groups']} "
            f"groups, {r['float_calls']} float calls in the run]: ordered "
            f"{r['ms']:.4f} ms (five runs bit-equal {r['runs_bit_equal']}),"
            f" index_add_ {r['index_add_ms']:.4f} ms (five runs bit-equal "
            f"{r['index_add_runs_bit_equal']}), hash path's gid sort "
            f"{r['sort_ms']:.4f} ms")
    return out


def joins_references(ref):
    """The joins phase's NdsNumpy references, in the order it asks."""
    from spark_rapids_tpu_torch.models.nds import NDS_JOINS_SETOPS
    return [(q, getattr(ref, q)) for q in NDS_JOINS_SETOPS
            if q in JOINS_NUMPY] + [("q93_outer", ref.q93_outer)]


def joins_setops_phase(torch, np, dev, session, ref, ahead, read_counts):
    """The NDS_JOINS_SETOPS queries on the SF10 session: JOINS_NUMPY and
    Q93_OUTER a first run and WARM_RUNS warm runs held against NdsNumpy
    (``ahead``: ``joins_references`` on a host thread),
    the other ten a first run and JOINS_WARM_RUNS warm runs held against
    their own first run at SF10 and, at
    JOINS_CROSS_ROWS, the card's rows against the port's CPU run (the
    plain versions, which tests/test_torch_nds.py holds against the JAX
    package): that checks the CUDA path, not the semantics. Returns
    ({query: numbers}, the widest batch B3 took)."""
    from spark_rapids_tpu_torch.models.nds import NDS_JOINS_SETOPS, NDS_QUERIES
    report, widest = {}, [None]
    try:
        for q in NDS_JOINS_SETOPS:
            report[q] = run_nds(
                torch, dev, read_counts, session, q, NDS_QUERIES[q], ref,
                (lambda q=q: ahead.get(q)) if q in JOINS_NUMPY else None,
                WARM_RUNS if q in JOINS_NUMPY else JOINS_WARM_RUNS, widest)
        report["q93_outer"] = run_nds(
            torch, dev, read_counts, session, "q93_outer", Q93_OUTER, ref,
            lambda: ahead.get("q93_outer"), WARM_RUNS, widest)
    finally:
        ahead.close()
    check(report["q93_outer"]["result_rows"] > 1000,
          "q93_outer: the left outer join kept too few customers")
    # the other ten: the card against the CPU at JOINS_CROSS_ROWS
    for q, n in cross_check(torch, dev, read_counts, [
            q for q in NDS_JOINS_SETOPS if q not in JOINS_NUMPY],
            JOINS_CROSS_ROWS).items():
        report[q]["cross_rows"] = n
    log("nds joins/setops summary " + json.dumps({q: {
        k: r[k] for k in ("first_s", "warm_s", "fact_rows_per_s",
                          "result_rows", "pallas_batches", "peak_gb")}
        | {"b3": r["launches"]["tile_group_reduce"]}
        for q, r in report.items()}))
    return report, widest[0]


def subquery_rollup_phase(torch, np, dev, session, ref, read_counts):
    """The 33 queries of NDS_SUBQUERY, NDS_ROLLUP and NDS_FUNCS on the
    SF10 session (q17 on its own tables at NDS_Q17_ROWS): SUBQ_NUMPY and
    Q10_OR a first run and WARM_RUNS warm runs held against NdsNumpy, the
    others a first run and JOINS_WARM_RUNS warm runs held against their
    own first run and, at
    JOINS_CROSS_ROWS, the card's rows against the port's CPU run. B3 must
    run under NDS_ROLLUP_B3_QUERIES. Returns ({query: numbers}, the
    widest batch B3 took)."""
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models.nds import (NDS_FUNCS, NDS_QUERIES,
                                                   NDS_ROLLUP, NDS_SUBQUERY,
                                                   register_nds)
    from spark_rapids_tpu_torch.plan.session import TpuSession
    report, widest = {}, [None]
    queries = NDS_SUBQUERY + NDS_ROLLUP + NDS_FUNCS

    def run(q, text, sess, reference, want_fn):
        report[q] = run_nds(torch, dev, read_counts, sess, q, text,
                            reference, want_fn,
                            JOINS_WARM_RUNS if want_fn is None
                            else WARM_RUNS, widest)
        log(f"nds {q} plan-time subqueries: {report[q]['analysis_s']:.4f} s "
            f"of the first run's {report[q]['first_s']:.4f} s")

    ahead = references_ahead(
        [(q, getattr(ref, q)) for q in queries
         if q in SUBQ_NUMPY and q != "q17"] + [("q10_or", ref.q10_or)])
    try:
        for q in queries:
            if q != "q17":
                run(q, NDS_QUERIES[q], session, ref,
                    (lambda q=q: ahead.get(q)) if q in SUBQ_NUMPY else None)
        run("q10_or", Q10_OR, session, ref, lambda: ahead.get("q10_or"))
    finally:
        ahead.close()
    check(report["q10_or"]["result_rows"] == 100,
          "q10_or: the existence markers kept too few customers")
    # q17 joins store_sales to store_returns and then catalog_sales on
    # (customer, item) before its date filter: with the zipf customer
    # keys the join grows with the cube of the scale
    small = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS}),
                       device=dev)
    host = {}
    register_nds(small, NDS_Q17_ROWS, host_tables=host)
    small_ref = NdsNumpy(np, host)
    log(f"nds q17's join of store_sales, store_returns and catalog_sales "
        f"on (customer, item) would hold {ref.q17_join_rows()} rows at "
        f"scale_rows {NDS_ROWS} before its date filter: it runs at "
        f"{NDS_Q17_ROWS}, where it holds {small_ref.q17_join_rows()}")
    run("q17", NDS_QUERIES["q17"], small, small_ref, small_ref.q17)
    del small, small_ref, host
    gc.collect()
    torch.cuda.empty_cache()
    # q67 ranks float sums whose ROLLUP subtotals tie in exact
    # arithmetic; B3 rounds the card's batches in another order than its
    # plain version does on the CPU, so a tie may break otherwise there:
    # the card's q67 is held against the CPU's ROLLUP sums with the ties
    # left open, and its ROLLUP aggregate against the CPU's as well
    held = {"q67": lambda rows, cpu: q67_ties_diff(
        rows, cpu.sql(Q67_ROLLUP).collect())}
    for q, n in cross_check(torch, dev, read_counts, [
            q for q in queries if q not in SUBQ_NUMPY] +
            [("q67_rollup", Q67_ROLLUP)], JOINS_CROSS_ROWS, held).items():
        report[q.replace("_rollup", "")]["cross_" + (
            "rollup_rows" if q.endswith("_rollup") else "rows")] = n
    rollup_b3 = [q for q in NDS_ROLLUP
                 if report[q]["launches"]["tile_group_reduce"]]
    check(rollup_b3, "B3 ran under no ROLLUP query")
    for q in NDS_ROLLUP_B3_QUERIES:
        check(report[q]["launches"]["tile_group_reduce"] > 0
              and report[q]["pallas_batches"] > 0,
              f"nds {q}: the grouped kernel (B3) did not run")
    log("nds subquery/rollup/funcs summary " + json.dumps({q: {
        k: r[k] for k in ("first_s", "warm_s", "fact_rows_per_s",
                          "result_rows", "pallas_batches", "peak_gb",
                          "analysis_s")}
        | {"b3": r["launches"]["tile_group_reduce"],
           "b1": r["launches"]["tile_reduce"]}
        for q, r in report.items()}))
    return report, widest[0]


#: the store_sales-scale window phase: (a) streams through
#: BatchedRunningWindowExec, (b) runs through two WindowExecs
WINDOW_KEYS = "ss_sold_date_sk, ss_ticket_number, ss_item_sk"
WINDOW_QUERIES = {
    "a_running": f"""
        SELECT ss_customer_sk, ss_sold_date_sk, ss_ticket_number,
               ss_item_sk, ss_net_paid,
               ROW_NUMBER() OVER (PARTITION BY ss_customer_sk
                                  ORDER BY {WINDOW_KEYS}) AS rn,
               RANK() OVER (PARTITION BY ss_customer_sk
                            ORDER BY {WINDOW_KEYS}) AS rk,
               SUM(ss_net_paid) OVER (PARTITION BY ss_customer_sk
                                      ORDER BY {WINDOW_KEYS}
                                      ROWS BETWEEN UNBOUNDED PRECEDING
                                      AND CURRENT ROW) AS run_paid
        FROM store_sales""",
    "b_partition": f"""
        SELECT ss_customer_sk, ss_net_paid,
               SUM(ss_net_paid) OVER (PARTITION BY ss_customer_sk)
                   AS cust_paid,
               LAG(ss_net_paid) OVER (PARTITION BY ss_customer_sk
                                      ORDER BY {WINDOW_KEYS}) AS prev_paid
        FROM store_sales""",
}


def stable_order(np, keys):
    """The stable sort order of rows by ``keys`` (int64 arrays, most
    significant first), as ``np.lexsort(keys[::-1])`` gives it: one
    stable argsort of the keys packed into one int64 (each shifted by
    its range) where their ranges fit, numpy's lexsort where not."""
    lows = [int(k.min()) for k in keys]
    spans = [int(k.max()) - lo + 1 for k, lo in zip(keys, lows)]
    if math.prod(spans) >= 1 << 62:
        return np.lexsort(keys[::-1])
    packed = np.zeros(len(keys[0]), np.int64)
    for k, lo, span in zip(keys, lows, spans):
        packed = packed * span + (k - lo)
    return np.argsort(packed, kind="stable")


def numpy_windows(np, ref):
    """Both windows over the host store_sales in numpy: a stable sort
    (``stable_order``) on (customer, date, ticket, item), nulls first (a null key is -1:
    every key is positive), segments where the customer changes, runs
    where any key changes. Returns {query: {column: (values, valid)}}:
    (a) in sorted order, as BatchedRunningWindowExec emits it, (b) in
    table order, as WindowExec keeps it."""
    cols = {c: ref.col("store_sales", c) for c in (
        "ss_customer_sk", "ss_sold_date_sk", "ss_ticket_number",
        "ss_item_sk", "ss_net_paid")}
    keys = [np.where(ok, v, -1).astype(np.int64) for v, ok in (
        cols[c] for c in ("ss_customer_sk", "ss_sold_date_sk",
                          "ss_ticket_number", "ss_item_sk"))]
    n = len(keys[0])
    order = stable_order(np, keys)
    sk = [k[order] for k in keys]
    new_part = np.r_[True, sk[0][1:] != sk[0][:-1]]
    new_run = new_part.copy()
    for k in sk[1:]:
        new_run |= np.r_[True, k[1:] != k[:-1]]
    pos = np.arange(n)
    part_start = np.maximum.accumulate(np.where(new_part, pos, 0))
    run_start = np.maximum.accumulate(np.where(new_run, pos, 0))
    paid, pok = cols["ss_net_paid"]
    s_paid, s_pok = paid[order], pok[order]
    vals = np.where(s_pok, s_paid, 0.0)
    run_paid = np.empty(n)
    run_cnt = np.empty(n, np.int64)
    starts = np.nonzero(new_part)[0]
    ends = np.r_[starts[1:], n]
    for lo, hi in zip(starts, ends):
        run_paid[lo:hi] = np.cumsum(vals[lo:hi])
        run_cnt[lo:hi] = np.cumsum(s_pok[lo:hi])
    tot = np.add.reduceat(vals, starts)
    tot_cnt = np.add.reduceat(s_pok.astype(np.int64), starts)
    seg = np.cumsum(new_part) - 1
    ones = np.ones(n, bool)
    a = {c: (v[order], ok[order]) for c, (v, ok) in cols.items()}
    a["rn"] = (pos - part_start + 1, ones)
    a["rk"] = (run_start - part_start + 1, ones)
    a["run_paid"] = (run_paid, run_cnt > 0)
    b_sorted = {"cust_paid": (tot[seg], tot_cnt[seg] > 0),
                "prev_paid": (np.r_[0.0, s_paid[:-1]],
                              np.r_[False, s_pok[:-1]] & ~new_part)}
    b = {"ss_customer_sk": cols["ss_customer_sk"],
         "ss_net_paid": cols["ss_net_paid"]}
    for c, (v, ok) in b_sorted.items():
        out_v, out_ok = np.empty_like(v), np.empty_like(ok)
        out_v[order], out_ok[order] = v, ok
        b[c] = (out_v, out_ok)
    return {"a_running": a, "b_partition": b}


def same_columns(np, table, want, label):
    """Column arrays of a HostTable against numpy's: masks equal, floats
    to RTOL, everything else exactly."""
    check(table.names == list(want), f"{label}: columns {table.names}")
    for name, (values, ok) in want.items():
        c = table.column(name)
        check(len(c) == len(ok), f"{label}: {name} has {len(c)} rows, "
              f"numpy {len(ok)}")
        check(np.array_equal(c.mask, ok), f"{label}: {name} nulls differ")
        got, ref = c.values[ok], values[ok]
        if ref.dtype.kind == "f":
            bad = ~np.isclose(got, ref, rtol=RTOL, atol=0.0)
        else:
            bad = got != ref
        check(not bad.any(), f"{label}: {name} differs in "
              f"{int(bad.sum())} rows (first at {int(np.argmax(bad))})")


def window_phase(torch, np, dev, session, ref, ahead):
    """Both store_sales-scale windows through session.sql on the card,
    each held against numpy on every row (``ahead``: a
    ``references_ahead`` whose "windows" entry is ``numpy_windows``,
    computed during the phases before; closed here); returns
    ({window: numbers}, {window: a function that runs it}, {window:
    numpy's columns})."""
    from spark_rapids_tpu_torch.exec.window import (BatchedRunningWindowExec,
                                                    WindowExec)
    t = time.perf_counter()
    try:
        want = ahead.get("windows")
    finally:
        ahead.close()
    log(f"window phase: numpy references ready after "
        f"{time.perf_counter() - t:.1f} s")
    rows = ref.rows("store_sales")
    report, runs = {}, {}
    for name, text in WINDOW_QUERIES.items():
        def run(text=text):
            return session.sql(text).to_table()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        table = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        same_columns(np, table, want[name], f"window {name}")
        del table
        physical, ctx = session._last_execution
        nodes, todo = [], [physical]
        while todo:
            nodes.append(todo.pop())
            todo.extend(nodes[-1].children)
        batched = [x for x in nodes if isinstance(x, BatchedRunningWindowExec)]
        whole = [x for x in nodes if isinstance(x, WindowExec)]
        if name == "a_running":
            check(len(batched) == 1 and not whole,
                  f"window {name}: ran {[type(x).__name__ for x in nodes]}")
            out_batches = ctx.metrics[batched[0].exec_id][
                "numOutputBatches"].value
            expect = -(-rows // BATCH_ROWS)
            check(out_batches == expect, f"window {name}: "
                  f"BatchedRunningWindowExec took {out_batches} batches, "
                  f"expected {expect}")
        else:
            check(len(whole) == 2 and not batched,
                  f"window {name}: ran {[type(x).__name__ for x in nodes]}")
            out_batches = None
        walls = []
        for _ in range(WARM_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            table = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            same_columns(np, table, want[name], f"window {name} warm")
            del table
        wall = statistics.median(walls) if walls else first
        physical, ctx = session._last_execution
        self_ms = sorted(operator_self_ms(physical, ctx.metrics, {}).items(),
                         key=lambda kv: -kv[1])
        report[name] = {"first_s": first, "warm_s": wall,
                        "warm_runs_s": walls, "rows": rows,
                        "rows_per_s": rows / wall,
                        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                        "execs": sorted({type(x).__name__ for x in nodes
                                         if "Window" in type(x).__name__}),
                        "window_batches": out_batches}
        log(f"window {name}: matches numpy on {rows} rows; first "
            f"{first:.4f} s, {warm_note(walls)}; {rows / wall:.4e} rows/s "
            f"(the {'warm median' if walls else 'first run'}); "
            f"execs {report[name]['execs']} ({out_batches} batches "
            f"streamed); max_memory_allocated {report[name]['peak_gb']:.3f}"
            " GB")
        log(f"window {name} operator self time (host clock, ms, last "
            "run): " + ", ".join(f"{k} {v:.1f}" for k, v in self_ms[:6]))
        runs[name] = run
    log("window summary " + json.dumps(report))
    return report, runs, want


# --- memory: out-of-core sort, runs under a cap, injected OOM, spill rate -----

OOC_SORT_QUERY = """
    SELECT ss_customer_sk, ss_sold_date_sk, ss_item_sk, ss_net_paid
    FROM store_sales
    ORDER BY ss_customer_sk, ss_sold_date_sk, ss_item_sk"""
OOC_SORT_KEYS = ("ss_customer_sk", "ss_sold_date_sk", "ss_item_sk")
#: srt.sql.sort.oocRowBudget's default (4,194,304 rows) and an in-core
#: budget above all 28,800,000 store_sales rows
OOC_ROW_BUDGET = 1 << 22
IN_CORE_ROW_BUDGET = 1 << 30
#: the queries run under a cap of the resident bytes plus CAP_SHARE of
#: their uncapped transient peak, chosen on the H100 (PERF.md section 4:
#: q4 and q47 finish under theirs too, in 156 s and 76 s; TPC-H q3 and
#: q67 die under theirs): window (a) spills, q82 retries and splits. NDS
#: q6 (spills too) is left out to keep the smoke inside its time: its
#: capped run took 25.8 s on the H100
CAPPED_QUERIES = ("window_a", "q82")
CAP_SHARE = 0.75
#: injected OOMs per query and mode, spread over its allocation attempts
#: (two: each is a whole run of the query)
INJECTIONS = 2
SPILL_TEST_BYTES = 1 << 30


class memory_conf:
    """The session runs with ``settings`` added to its conf, a device
    budget and spill catalog made anew from that conf, and the caching
    allocator capped at ``cap`` bytes (None: uncapped); all restored on
    exit."""

    def __init__(self, torch, dev, session, settings, cap=None):
        self.torch, self.dev, self.session = torch, dev, session
        self.settings, self.cap = settings, cap

    def _fresh(self, conf):
        from spark_rapids_tpu_torch.memory.budget import reset_device_budget
        from spark_rapids_tpu_torch.memory.spill import reset_spill_catalog
        gc.collect()
        self.torch.cuda.empty_cache()
        reset_device_budget(None)
        reset_spill_catalog(conf=conf, device=self.dev)

    def __enter__(self):
        from spark_rapids_tpu_torch.conf import SrtConf
        self.saved = self.session.conf
        self.session.conf = SrtConf({**self.saved._settings,
                                     **self.settings})
        self._fresh(self.session.conf)
        if self.cap is not None:
            from spark_rapids_tpu_torch.memory.budget import \
                expandable_segments_enabled
            check(expandable_segments_enabled(),
                  "a capped run needs PYTORCH_CUDA_ALLOC_CONF="
                  "expandable_segments:True")
            total = self.torch.cuda.get_device_properties(
                self.dev).total_memory
            self.torch.cuda.set_per_process_memory_fraction(
                self.cap / total, self.dev)
        return self

    def __exit__(self, *exc):
        if self.cap is not None:
            self.torch.cuda.set_per_process_memory_fraction(1.0, self.dev)
        self.session.conf = self.saved
        self._fresh(self.saved)
        return False


def measured(torch, dev, session, run):
    """``run()`` with the peak counters reset just before: (result,
    seconds, resident bytes before, peak bytes, the query's memory
    counters)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    memory = dict(session._last_execution[1].memory)
    return out, secs, resident, torch.cuda.max_memory_allocated(dev), memory


def ooc_sort_reference(np, ref):
    """numpy's stable sort of store_sales by OOC_SORT_KEYS: (rows, the
    sorted key columns, the sorted ss_net_paid, seconds)."""
    cols = {c: ref.col("store_sales", c) for c in OOC_SORT_KEYS
            + ("ss_net_paid",)}
    t = time.perf_counter()
    # nulls first: every key is positive, a null is -1
    keys = [np.where(ok, v, -1).astype(np.int64) for v, ok in (
        cols[c] for c in OOC_SORT_KEYS)]
    order = stable_order(np, keys)
    want = [(cols[c][0][order], cols[c][1][order]) for c in OOC_SORT_KEYS]
    paid, pok = cols["ss_net_paid"]
    return len(order), want, (paid[order], pok[order]), \
        time.perf_counter() - t


def ooc_sort_phase(torch, np, dev, session, ahead):
    """(a) ORDER BY over all store_sales rows out of core at the default
    row budget and in core, each held against numpy's stable sort
    (``ooc_sort_reference``, on a host thread since the window phase)."""
    t = time.perf_counter()
    n_rows, want, want_paid, sort_s = ahead.get("ooc_sort")
    log(f"memory (a): numpy's stable sort of {n_rows} rows in {sort_s:.1f} "
        f"s on a host thread (waited {time.perf_counter() - t:.1f} s)")
    report = {}
    tables = {}
    for label, budget in (("out_of_core", OOC_ROW_BUDGET),
                          ("in_core", IN_CORE_ROW_BUDGET)):
        with memory_conf(torch, dev, session,
                         {"srt.sql.sort.oocRowBudget": budget}):
            table, secs, resident, peak, mem = measured(
                torch, dev, session,
                lambda: session.sql(OOC_SORT_QUERY).to_table())
            physical, ctx = session._last_execution
        # both paths keep rows tied on the keys in input order, as the
        # stable argsort does: every column equals numpy's, row by row
        want_cols = dict(zip(OOC_SORT_KEYS + ("ss_net_paid",),
                             want + [want_paid]))
        same_columns(np, table, want_cols, f"memory (a) {label}")
        m = ctx.metric_totals()
        report[label] = {"seconds": secs, "transient_gb": (peak - resident)
                         / 1e9, "peak_gb": peak / 1e9,
                         "resident_gb": resident / 1e9,
                         "spilled_bytes": mem["spilledBytes"],
                         "ooc_peak_rows": m.get("sortOocPeakRows", 0),
                         "output_batches": m.get("numOutputBatches", 0)}
        log(f"memory (a) {label} (oocRowBudget {budget}): matches numpy's "
            f"stable sort on {n_rows} rows in {secs:.4f} s; transient peak "
            f"{(peak - resident) / 1e9:.3f} GB over {resident / 1e9:.3f} "
            f"GB resident; spilled {mem['spilledBytes']} bytes; merge carry "
            f"peak {report[label]['ooc_peak_rows']} rows")
        tables[label] = table
        del table
    check(tables_equal(np, tables["out_of_core"], tables["in_core"]),
          "memory (a): the out-of-core rows differ from the in-core rows")
    check(report["out_of_core"]["ooc_peak_rows"] > 0,
          "memory (a): the out-of-core merge did not run")
    check(report["in_core"]["ooc_peak_rows"] == 0,
          "memory (a): the in-core budget took the out-of-core path")
    check(report["out_of_core"]["transient_gb"]
          < report["in_core"]["transient_gb"],
          "memory (a): the out-of-core transient peak is not below the "
          "in-core one")
    del tables
    return report


def nds_session_at(torch, np, dev, scale):
    """A session with the 24 NDS tables at ``scale_rows`` on the card, and
    their NdsNumpy reference."""
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models.nds import register_nds
    from spark_rapids_tpu_torch.plan.session import TpuSession
    session = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS}),
                         device=dev)
    host = {}
    register_nds(session, scale, host_tables=host)
    return session, NdsNumpy(np, host)


def capped_runs(torch, np, dev, session, name, run, same, held=None):
    """(b) ``run()`` uncapped, then under a cap of the resident bytes plus
    CAP_SHARE of its uncapped transient peak: equal rows (and, with
    ``held``, a check that raises on a result numpy disagrees with, each
    run held), spill / retry / split counted, peak under the cap."""
    with memory_conf(torch, dev, session, {}):
        rows, secs, resident, peak, mem = measured(torch, dev, session, run)
    if held is not None:
        held(rows)
    transient = peak - resident
    cap = resident + int(CAP_SHARE * transient)
    log(f"memory (b) {name}: uncapped {secs:.4f} s, peak "
        f"{peak / 1e9:.3f} GB ({transient / 1e9:.3f} GB over "
        f"{resident / 1e9:.3f} GB resident); cap {cap} bytes "
        f"({cap / 1e9:.3f} GB)")
    with memory_conf(torch, dev, session,
                     {"srt.memory.tpu.poolSize": cap}, cap=cap):
        got, c_secs, _, c_peak, c_mem = measured(torch, dev, session, run)
    check(same(got, rows), f"memory (b) {name}: capped run differs from "
          "the uncapped run")
    if held is not None:
        held(got)
    acted = c_mem["spilledBytes"] + c_mem["retryCount"] + \
        c_mem["splitAndRetryCount"]
    check(acted > 0, f"memory (b) {name}: no spill, retry or split under "
          f"the cap ({c_mem})")
    check(c_peak <= cap, f"memory (b) {name}: peak {c_peak} over the cap "
          f"{cap}")
    log(f"memory (b) {name}: capped run matches in {c_secs:.4f} s, peak "
        f"{c_peak / 1e9:.3f} GB <= cap {cap / 1e9:.3f} GB; spilled "
        f"{c_mem['spilledBytes']} bytes, retries {c_mem['retryCount']}, "
        f"splits {c_mem['splitAndRetryCount']}, spill time "
        f"{c_mem['spillTimeNs'] / 1e9:.3f} s")
    return {"uncapped_s": secs, "uncapped_peak_gb": peak / 1e9,
            "resident_gb": resident / 1e9, "cap_gb": cap / 1e9,
            "capped_s": c_secs, "capped_peak_gb": c_peak / 1e9, **c_mem}


class _Held:
    """Stands in for a kernel wrapper: calls go to ``check``, its launch
    counters (read and written by name inside the wrapper module) stay
    the wrapper's own."""

    def __init__(self, fn, check_fn):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_check", check_fn)

    def __call__(self, *a, **k):
        return self._check(*a, **k)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class holding_launches:
    """Every launch of B1 (``tile_reduce``) and B3 (``tile_group_reduce``)
    inside the block is held against the kernel's plain version on the
    same inputs (the plain calls launch nothing): the smoke's one hold of
    the kernels on the main path. ``widest`` keeps the B3 batch with the
    most live rows: (live rows, groups, gid, lanes)."""

    def __init__(self, torch, DK):
        self.torch, self.DK = torch, DK
        self.held = {"tile_reduce": 0, "tile_group_reduce": 0}
        self.err = {"tile_reduce": 0.0, "tile_group_reduce": 0.0}
        self.widest = None

    def __enter__(self):
        torch, DK = self.torch, self.DK
        self.saved = DK.tile_reduce, DK.tile_group_reduce
        b1, b3 = self.saved

        def tile_reduce(inputs, row_fn, kinds):
            got = b1(inputs, row_fn, kinds)
            ref = DK.tile_reduce_plain(inputs, row_fn, kinds)
            finite = torch.isfinite(ref)
            diff = (got - ref).abs()
            check(torch.equal(torch.isnan(got), torch.isnan(ref)) and bool(
                torch.all(torch.where(finite, diff <= RTOL * ref.abs(),
                                      got == ref) | torch.isnan(ref))),
                f"tile_reduce disagrees with its plain version on a "
                f"{inputs[0].shape[0]}-row batch")
            self.err["tile_reduce"] = max(
                self.err["tile_reduce"],
                float(torch.where(finite, diff, 0.0).max()))
            self.held["tile_reduce"] += 1
            return got

        def tile_group_reduce(gid, values, **kw):
            got = b3(gid, values, **kw)
            ref = DK.tile_group_reduce_plain(
                gid, values, **{k: v for k, v in kw.items()
                                if k == "num_buckets"})
            g, r = torch.stack(got), torch.stack(ref)
            check(torch.allclose(g, r, rtol=RTOL, atol=0.0),
                  f"tile_group_reduce disagrees with its plain version on "
                  f"a {gid.shape[0]}-row batch")
            self.err["tile_group_reduce"] = max(
                self.err["tile_group_reduce"], float((g - r).abs().max()))
            self.held["tile_group_reduce"] += 1
            groups = kw.get("num_groups") or DK.GROUP_BUCKETS
            live = int((gid < groups).sum())
            if self.widest is None or live > self.widest[0]:
                self.widest = (live, groups, gid, values)
            return got
        DK.tile_reduce = _Held(b1, tile_reduce)
        DK.tile_group_reduce = _Held(b3, tile_group_reduce)
        return self

    def __exit__(self, *exc):
        self.DK.tile_reduce, self.DK.tile_group_reduce = self.saved
        return False


def injected_runs(torch, dev, session, read_counts, name, run, same, want,
                  kernel):
    """(c) ``run()`` clean, then with RetryOOM and with SplitAndRetryOOM
    injected at INJECTIONS allocation attempts spread over the clean
    run's: every run equals the clean one (and numpy's), every injection
    reaches a retry or a split, and every B1 / B3 launch is held against
    the plain version; ``kernel`` (a launch counter) must launch once
    more per split. Returns the numbers and the launches of the block."""
    from spark_rapids_tpu_torch.memory.budget import task_context
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    launched = {k: 0 for k in read_counts()}

    def counted(fn):
        DK.reset_counts()
        out = fn()
        now = read_counts()
        for k in launched:
            launched[k] += now[k]
        return out, now
    with memory_conf(torch, dev, session, {}):
        clean, clean_counts = counted(run)
        check(same(clean, want), f"memory (c) {name}: clean run differs "
              "from numpy")
        total = session._last_execution[1].memory["allocAttempts"]
        offsets = sorted({(total - 1) * (i + 1) // (INJECTIONS + 1)
                          for i in range(INJECTIONS)})
        out = {"alloc_attempts": total, "offsets": offsets}
        with holding_launches(torch, DK) as hold:
            for mode in ("retry", "split"):
                retries = splits = 0
                for at in offsets:
                    tc = task_context()
                    if mode == "retry":
                        tc.force_retry_oom(at)
                    else:
                        tc.force_split_and_retry_oom(at)
                    got, counts = counted(run)
                    check(same(got, clean), f"memory (c) {name}: {mode} "
                          f"injected at {at} differs from the clean run")
                    mem = session._last_execution[1].memory
                    check(mem["retryCount"] + mem["splitAndRetryCount"]
                          >= 1, f"memory (c) {name}: the {mode} injected at "
                          f"{at} reached no retry or split")
                    if kernel is not None:
                        check(counts[kernel] == clean_counts[kernel]
                              + mem["splitAndRetryCount"],
                              f"memory (c) {name}: {kernel} launched "
                              f"{counts[kernel]} times with "
                              f"{mem['splitAndRetryCount']} splits, clean "
                              f"{clean_counts[kernel]}")
                    retries += mem["retryCount"]
                    splits += mem["splitAndRetryCount"]
                out[mode] = {"retries": retries, "splits": splits}
        if kernel is not None:
            check(out["split"]["splits"] > 0, f"memory (c) {name}: no "
                  "injected split landed where a batch could be halved")
        out["held"] = dict(hold.held)
        out["max_abs_err"] = dict(hold.err)
    log(f"memory (c) {name}: {total} allocation attempts; RetryOOM and "
        f"SplitAndRetryOOM at {offsets} all match the clean run ({out}); "
        f"launches in the block {launched}")
    return out, launched


def spill_rate(torch, np, dev):
    """(d) One ~1 GB SpillableBatch device -> pinned host -> device, GB/s
    beside the PCIe link's nominal rate."""
    from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                        ColumnarBatch)
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    from spark_rapids_tpu_torch.memory.spill import (SpillableBatch,
                                                     SpillCatalog)
    n = SPILL_TEST_BYTES // 9  # float64 data + bool validity
    cat = SpillCatalog(budget=MemoryBudget(4 * SPILL_TEST_BYTES),
                       host_limit=4 * SPILL_TEST_BYTES)
    cat.verify_checksums = False  # the copies alone
    col = ColumnVector(torch.rand(n, dtype=torch.float64, device=dev),
                       torch.ones(n, dtype=torch.bool, device=dev),
                       dt.FLOAT64)
    want = float(col.data.sum())
    sb = SpillableBatch(ColumnarBatch([col], ["v"], n, dev), catalog=cat)
    del col
    d2h, h2d = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sb.spill_to_host()
        sb._wait_host()
        d2h.append(time.perf_counter() - t)
        t = time.perf_counter()
        back = sb.get()
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t)
        check(float(back.columns[0].data.sum()) == want,
              "memory (d): the batch changed on its way back")
        del back
    nbytes = sb.nbytes
    sb.close()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    link = [x.strip() for x in smi.split(",")]
    # GT/s per lane and line-code efficiency by PCIe generation; the
    # current link where nvidia-smi reads it, else the card's maximum,
    # else the H100 SXM5 data sheet's link (PCIe Gen 5 x16)
    gts = {1: (2.5, 0.8), 2: (5.0, 0.8), 3: (8.0, 128 / 130),
           4: (16.0, 128 / 130), 5: (32.0, 128 / 130)}
    gen = next((int(g) for g in (link[0], link[2]) if g.isdigit()), None)
    width = next((int(w) for w in (link[1], link[3]) if w.isdigit()), None)
    source = "nvidia-smi"
    if gen not in gts or not width:
        gen, width, source = 5, 16, "the H100 SXM5 data sheet"
    rate, eff = gts[gen]
    nominal = rate * eff * width / 8
    out = {"bytes": nbytes, "d2h_gbps": [nbytes / s / 1e9 for s in d2h],
           "h2d_gbps": [nbytes / s / 1e9 for s in h2d],
           "pcie_link": smi, "link_nominal_gbps": nominal,
           "link_nominal_from": f"{source}: PCIe gen {gen} x{width}"}
    log(f"memory (d): a {nbytes / 1e9:.3f} GB SpillableBatch device -> "
        f"pinned host {[round(x, 2) for x in out['d2h_gbps']]} GB/s, host "
        f"-> device {[round(x, 2) for x in out['h2d_gbps']]} GB/s (the "
        f"first copy out pins the host buffer); nvidia-smi's PCIe link "
        f"(gen current, width current, gen max, width max): {smi}; "
        f"nominal {nominal:.2f} GB/s per direction ({source}: PCIe gen "
        f"{gen} x{width})")
    return out


def tables_equal(np, a, b):
    """Two HostTables with equal columns in equal row order (floats to
    RTOL)."""
    if a.names != b.names or a.num_rows != b.num_rows:
        return False
    for x, y in zip(a.columns, b.columns):
        if not np.array_equal(x.mask, y.mask):
            return False
        vx, vy = x.values, y.values
        if hasattr(vx, "to_objects"):
            if not (np.array_equal(vx.offsets, vy.offsets)
                    and np.array_equal(vx.chars, vy.chars)):
                return False
        elif vx.dtype.kind == "f":
            if not np.allclose(vx[x.mask], vy[y.mask], rtol=RTOL, atol=0.0):
                return False
        elif not np.array_equal(vx[x.mask], vy[y.mask]):
            return False
    return True


def memory_phase(torch, np, dev, nds, nds_ref, ooc_ahead, tpch_session,
                 tpch_runs, window_run, window_want, read_counts):
    """The memory layer on the card: (a) the out-of-core sort, (b) queries
    under a cap below their uncapped peak, (c) injected OOMs with B1 and
    B3 held on every batch they take, split halves included, (d) the
    spill copies' rate. Returns (numbers, the kernel launches of (c))."""
    from spark_rapids_tpu_torch.models.nds import NDS_QUERIES
    from spark_rapids_tpu_torch.testing import compare_rows, order_keys
    t0 = time.perf_counter()
    report = {"ooc_sort": ooc_sort_phase(torch, np, dev, nds, ooc_ahead)}

    def nds_query(session, q):
        df = session.sql(NDS_QUERIES[q])
        keys, limit = order_keys(NDS_QUERIES[q], df.columns)

        def same(got, want):
            return compare_rows(got, want, keys, limit, RTOL) is None
        return (lambda: session.sql(NDS_QUERIES[q]).collect()), same

    capped = {}
    for name in CAPPED_QUERIES:
        if name == "window_a":
            capped[name] = capped_runs(
                torch, np, dev, nds, name, window_run,
                lambda got, want: tables_equal(np, got, want),
                lambda table: same_columns(np, table, window_want[
                    "a_running"], "memory (b) window_a"))
            continue
        session, ref = nds, nds_ref
        if name == "q82":
            # at SF1 on its own tables, as the NDS phase runs it
            session, ref = nds_session_at(torch, np, dev, NDS_Q82_ROWS)
        run, same = nds_query(session, name)
        want = getattr(ref, name)()

        def held(rows, name=name, want=want, same=same):
            check(same(rows, want), f"memory (b) {name}: differs from "
                  "numpy")
        capped[name] = capped_runs(torch, np, dev, session, name, run, same,
                                   held)
        del session, ref
        gc.collect()
    report["capped"] = capped

    launched = {k: 0 for k in read_counts()}
    injected = {}
    nds_q3, nds_same = nds_query(nds, "q3")
    for name, (run, want, kernel, same) in (
            ("q1", tpch_runs["q1"]), ("q6", tpch_runs["q6"]),
            ("strings_lineitem", tpch_runs["strings_lineitem"]),
            ("nds_q3", (nds_q3, nds_ref.q3(), None, nds_same))):
        session = nds if name == "nds_q3" else tpch_session
        injected[name], got = injected_runs(
            torch, dev, session, read_counts, name, run, same, want, kernel)
        for k in launched:
            launched[k] += got[k]
    report["injected"] = injected
    report["spill_rate"] = spill_rate(torch, np, dev)
    report["seconds"] = time.perf_counter() - t0
    log("memory summary " + json.dumps(report))
    return report, launched


# --- phase 5b: the scalar expression library on the TPC-H tables ----------

#: the zone scalar_phase's time-zone query converts through; a card
#: machine without a tz database takes SCALAR_FIXED_ZONE (logged)
SCALAR_ZONE = "America/Los_Angeles"
SCALAR_FIXED_ZONE = "+08:00"
#: l_partkey of the rows whose CAST(l_quantity AS STRING) is held string
#: by string against Java's Double.toString
SCALAR_SAMPLE_PARTKEY = 4242
#: expression types of s7_fused's filter (B1's new generator arms) that
#: the fused plan must hold, with no FilterExec run beside it
S7_FUSED_NODES = ("Cast", "Abs", "Greatest")


def scalar_queries(zone):
    """{name: (SQL text, the launch counters that must be non-zero)}:
    the scalar library (strings, LIKE and regex, dates, timestamps and a
    time zone, integral arithmetic, math, hashes, casts, FIRST / LAST)
    over lineitem, orders and customer."""
    return {
        "s1_strings": ("""
SELECT k, n, u, SUM(p) AS sp, SUM(q) AS sq, COUNT(*) AS c
FROM (SELECT l_returnflag || '-' || lower(l_linestatus) AS k,
             length(concat(l_returnflag, l_linestatus)) AS n,
             upper(concat_ws('/', l_linestatus, l_returnflag)) AS u,
             l_extendedprice AS p, l_quantity AS q
      FROM lineitem) x
GROUP BY k, n, u ORDER BY k""", ("tile_group_reduce",)),
        "s2_regex": ("""
SELECT pr, r, s4, SUM(o_totalprice) AS t, COUNT(*) AS c
FROM (SELECT regexp_extract(o_orderpriority, '^([0-9])-', 1) AS pr,
             regexp_replace(o_orderpriority, '[0-9]-', '') AS r,
             substr(o_orderpriority, 3, 4) AS s4, o_totalprice
      FROM orders
      WHERE o_orderpriority LIKE '%URGENT'
         OR o_orderpriority RLIKE 'LOW$') x
GROUP BY pr, r, s4 ORDER BY pr""", ("tile_group_reduce",)),
        "s3_string_order": ("""
SELECT COUNT(*) AS n, SUM(o_totalprice) AS t,
       MIN(lpad(trim(o_orderpriority), 12, '*')) AS lp,
       MAX(locate('-', o_orderpriority)) AS loc
FROM orders
WHERE o_orderpriority BETWEEN '2-HIGH' AND '4-NOT SPECIFIED'
  AND o_orderpriority <> '3-MEDIUM'""", ()),
        "s3_segments": ("""
SELECT c_mktsegment AS m, COUNT(*) AS n FROM customer
WHERE c_mktsegment >= 'AUTOMOBILE' AND c_mktsegment < 'HOUSEHOLD'
GROUP BY c_mktsegment ORDER BY m""", ()),
        "s4_dates": ("""
SELECT y, qtr, SUM(CAST(m AS DOUBLE)) AS sm, SUM(CAST(dw AS DOUBLE)) AS sdw,
       SUM(CAST(datediff(ld, d) AS DOUBLE)) AS sld,
       SUM(CAST(dd AS DOUBLE)) AS sdd,
       SUM(CAST(datediff(da, d) AS DOUBLE)) AS sda, COUNT(*) AS c
FROM (SELECT year(l_shipdate) AS y, quarter(l_shipdate) AS qtr,
             month(l_shipdate) AS m, dayofweek(l_shipdate) AS dw,
             last_day(l_shipdate) AS ld, l_shipdate AS d,
             datediff(l_shipdate, DATE '1992-01-01') AS dd,
             date_add(l_shipdate, 30) AS da
      FROM lineitem
      WHERE l_shipdate + INTERVAL 90 DAYS < DATE '1998-12-01') x
GROUP BY y, qtr ORDER BY y, qtr""", ("tile_group_reduce",)),
        "s5_timestamps": (f"""
SELECT COUNT(*) AS n, SUM(h) AS sh, MIN(f) AS mf, MAX(t2) AS mt,
       MIN(w) AS mw
FROM (SELECT hour(from_utc_timestamp(ts, '{zone}')) AS h,
             from_unixtime(o_orderkey) AS f,
             to_utc_timestamp(ts, '{zone}') AS t2,
             from_utc_timestamp(ts, '{zone}') AS w
      FROM (SELECT CAST(o_orderdate AS TIMESTAMP) AS ts, o_orderkey
            FROM orders) y
      WHERE ts < TIMESTAMP '1995-03-15 12:00:00') x""", ()),
        "s6_integral": ("""
SELECT pm, SUM(CAST(r AS DOUBLE)) AS sr, SUM(CAST(q AS DOUBLE)) AS sq,
       SUM(lg) AS slg, SUM(gr) AS sgr, COUNT(*) AS c
FROM (SELECT pmod(l_orderkey, 7) AS pm, l_orderkey % 97 AS r,
             l_orderkey div 1000 AS q, least(l_tax, l_discount) AS lg,
             greatest(l_quantity, l_tax * 100.0) AS gr
      FROM lineitem) x
GROUP BY pm ORDER BY pm""", ("tile_group_reduce",)),
        "s7_fused": ("""
SELECT SUM(l_extendedprice * l_discount) AS revenue, COUNT(*) AS n
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01'
  AND CAST(l_quantity AS INT) < 24 AND abs(l_discount - 0.06) <= 0.011
  AND greatest(l_tax, 0.02) < 0.08""", ("tile_reduce",)),
        "s8_math": ("""
SELECT SUM(sqrt(l_extendedprice)) AS a, SUM(ln(l_quantity)) AS b,
       SUM(exp(l_tax)) AS c, SUM(pow(l_discount, 2.0)) AS d,
       SUM(floor(l_quantity)) AS e, SUM(ceil(l_quantity)) AS f,
       SUM(signum(l_tax - 0.04)) AS g, SUM(atan2(l_tax, l_discount)) AS h,
       SUM(hypot(l_tax, l_discount)) AS i
FROM lineitem""", ()),
        "s9_hashes": ("""
SELECT SUM(pmod(xxhash64(l_orderkey, l_partkey), 1000)) AS x,
       SUM(pmod(hash(l_returnflag, l_shipdate), 1000)) AS m, COUNT(*) AS n
FROM lineitem""", ()),
        "s10_casts": ("""
SELECT SUM(CAST(CAST(l_orderkey AS STRING) AS BIGINT)) AS b,
       SUM(CAST(CAST(CAST(l_quantity AS STRING) AS DOUBLE) = l_quantity
                AS INT)) AS qrt,
       MIN(CAST(l_shipdate AS STRING)) AS mn,
       MAX(CAST(l_shipdate AS STRING)) AS mx,
       SUM(CAST(l_shipdate = CAST('1995-03-15' AS DATE) AS INT)) AS d,
       COUNT(*) AS n
FROM lineitem""", ()),
        "s10_sample": (f"""
SELECT l_orderkey, l_quantity, CAST(l_quantity AS STRING) AS qs,
       CAST(l_shipdate AS STRING) AS ds
FROM lineitem WHERE l_partkey = {SCALAR_SAMPLE_PARTKEY}
ORDER BY l_orderkey, qs""", ()),
        "s11_first_last": ("""
SELECT l_returnflag, first(l_orderkey) AS f, last(l_orderkey) AS l,
       first(l_shipdate) AS fd, last(l_extendedprice) AS lp, COUNT(*) AS n
FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag""", ()),
    }


def java_double_string(x):
    """Java's Double.toString from Python's shortest repr (the
    reference for CAST(double AS STRING))."""
    from decimal import Decimal
    if x != x:
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    t = Decimal(repr(abs(float(x)))).normalize().as_tuple()
    digits = "".join(map(str, t.digits))
    sx = len(digits) - 1 + t.exponent
    sign = "-" if x < 0 else ""
    if -3 <= sx < 7:
        if sx >= 0:
            return sign + (digits + "0" * 8)[:sx + 1] + "." + \
                (digits[sx + 1:] or "0")
        return sign + "0." + "0" * (-sx - 1) + digits
    return sign + digits[0] + "." + (digits[1:] or "0") + "E" + str(sx)


def numpy_xxhash64_long(np, v, seed):
    """Spark's XxHash64.hashLong over uint64 lanes (numpy wraps)."""
    p1, p2 = np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F)
    p3, p4 = np.uint64(0x165667B19E3779F9), np.uint64(0x85EBCA77C2B2AE63)
    p5 = np.uint64(0x27D4EB2F165667C5)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))
    h = seed + p5 + np.uint64(8)
    h = h ^ (rotl(v * p2, 31) * p1)
    h = rotl(h, 27) * p1 + p4
    h = h ^ (h >> np.uint64(33))
    h = h * p2
    h = h ^ (h >> np.uint64(29))
    h = h * p3
    return h ^ (h >> np.uint64(32))


def numpy_murmur3_step(np, k1, h1):
    """Murmur3_x86_32's mixK1 then mixH1, uint32 lanes."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    k1 = rotl(k1 * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)
    h1 = rotl(h1 ^ k1, 13)
    return h1 * np.uint32(5) + np.uint32(0xE6546B64)


def numpy_murmur3_fmix(np, h1, length):
    h1 = h1 ^ np.uint32(length)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = h1 * np.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = h1 * np.uint32(0xC2B2AE35)
    return h1 ^ (h1 >> np.uint32(16))


def scalar_references(np, li, od, cu, zone, chunk=1 << 22):
    """numpy / Python references of scalar_queries over the host copies
    of the columns: choice strings through their codes (Python's str and
    re on each distinct value), dates through numpy datetime64, the time
    zone through zoneinfo (or the fixed offset) per distinct date, the
    hashes through numpy's wrapping uint arithmetic."""
    import zoneinfo
    epoch = datetime.date(1970, 1, 1)
    utc = datetime.timezone.utc

    def codes(hs, width=16):
        """(distinct strings, each row's index into them) of a column of
        choice strings: each row's first ``width`` bytes and length
        hashed to one uint64, np.unique over the hashes, and every row
        checked byte for byte against its code's first row."""
        offs = hs.offsets.astype(np.int64)
        lens = np.diff(offs)
        if len(lens) and int(lens.min()) == int(lens.max()) == 1:
            # one byte a row (l_returnflag, l_linestatus): the byte
            byte = hs.chars[offs[:-1]]
            uniq, inv = np.unique(byte, return_inverse=True)
            return [bytes([b]).decode() for b in uniq], inv.reshape(-1)
        check(int(lens.max()) <= width, "choice strings fit the key")
        keys = np.empty(len(lens), np.uint64)
        words = np.empty((len(lens), width // 8), np.uint64)
        last = max(len(hs.chars) - 1, 0)
        for s0 in range(0, len(lens), chunk):
            o, n = offs[:-1][s0:s0 + chunk], lens[s0:s0 + chunk]
            k = np.arange(width)
            mat = np.where(k < n[:, None], hs.chars[np.minimum(
                o[:, None] + k, last)], 0).astype(np.uint8)
            w = np.ascontiguousarray(mat).view(np.uint64)
            words[s0:s0 + len(n)] = w
            h = n.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            for j in range(w.shape[1]):
                h = (h ^ w[:, j]) * np.uint64(0xC2B2AE3D27D4EB4F)
            keys[s0:s0 + len(n)] = h
        _, first, inv = np.unique(keys, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
        check(bool(np.all(words == words[first][inv]))
              and bool(np.all(lens == lens[first][inv])),
              "choice string codes are exact")
        values = [bytes(hs.chars[offs[i]:offs[i + 1]]).decode()
                  for i in first]
        return values, inv

    def grouped(keys_inv, n, **sums):
        out = {}
        for name, w in sums.items():
            out[name] = np.bincount(keys_inv, weights=w, minlength=n)
        return out

    refs = {}
    rf_u, rf = codes(li["rf"])
    ls_u, ls = codes(li["ls"])
    # s1: six (flag, status) groups
    g = rf * len(ls_u) + ls
    sums = grouped(g, len(rf_u) * len(ls_u), sp=li["price"], sq=li["qty"])
    cnt = np.bincount(g, minlength=len(rf_u) * len(ls_u))
    rows = []
    for i in range(len(rf_u)):
        for j in range(len(ls_u)):
            k = i * len(ls_u) + j
            if cnt[k]:
                a, b = rf_u[i], ls_u[j]
                rows.append({"k": a + "-" + b.lower(), "n": len(a + b),
                             "u": (b + "/" + a).upper(),
                             "sp": float(sums["sp"][k]),
                             "sq": float(sums["sq"][k]), "c": int(cnt[k])})
    refs["s1_strings"] = sorted(rows, key=lambda r: r["k"].encode())
    # s2: priorities through Python's re
    pr_u, pr = codes(od["prio"])
    keep_u = [bool(re.search(r"URGENT\Z", p)) or bool(re.search("LOW$", p))
              for p in pr_u]
    rows = {}
    for i, p in enumerate(pr_u):
        if not keep_u[i]:
            continue
        m = re.search(r"^([0-9])-", p)
        key = (m.group(1) if m else "", re.sub("[0-9]-", "", p), p[2:6])
        sel = pr == i
        r = rows.setdefault(key, [0.0, 0])
        r[0] += float(np.sum(od["total"][sel]))
        r[1] += int(sel.sum())
    refs["s2_regex"] = [{"pr": k[0], "r": k[1], "s4": k[2], "t": v[0],
                         "c": v[1]} for k, v in sorted(
                             rows.items(), key=lambda kv: kv[0][0].encode())]
    # s3: byte order of the priorities and segments
    inside = [b"2-HIGH" <= p.encode() <= b"4-NOT SPECIFIED" and
              p != "3-MEDIUM" for p in pr_u]
    sel = np.asarray(inside)[pr]
    lp = [p.strip(" ") for p in pr_u]
    lp = [(("*" * 12) + p)[-12:] if len(p) < 12 else p[:12] for p in lp]
    refs["s3_string_order"] = [{
        "n": int(sel.sum()), "t": float(np.sum(od["total"][sel])),
        "lp": min((lp[i] for i in range(len(pr_u)) if inside[i]),
                  key=lambda v: v.encode()),
        "loc": max(pr_u[i].find("-") + 1 for i in range(len(pr_u))
                   if inside[i])}]
    seg_u, seg = codes(cu["seg"])
    seg_rows = [{"m": m, "n": int((seg == i).sum())}
                for i, m in enumerate(seg_u)
                if b"AUTOMOBILE" <= m.encode() < b"HOUSEHOLD"]
    refs["s3_segments"] = sorted(seg_rows, key=lambda r: r["m"].encode())
    # s4: calendar fields through datetime64
    ship = li["ship"].astype(np.int64)
    keep = ship + 90 < (datetime.date(1998, 12, 1) - epoch).days
    d = ship[keep].astype("datetime64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    mo = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    qtr = (mo - 1) // 3 + 1
    dw = (ship[keep] + 4) % 7 + 1
    nxt = (d.astype("datetime64[M]") + 1).astype("datetime64[D]")
    last = nxt.astype(np.int64) - 1
    dd = ship[keep] - (datetime.date(1992, 1, 1) - epoch).days
    key = y * 10 + qtr
    uk, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    s = grouped(inv, len(uk), sm=mo.astype(np.float64),
                sdw=dw.astype(np.float64),
                sld=(last - ship[keep]).astype(np.float64),
                sdd=dd.astype(np.float64))
    cnt = np.bincount(inv, minlength=len(uk))
    refs["s4_dates"] = [{"y": int(k // 10), "qtr": int(k % 10),
                         "sm": float(s["sm"][i]), "sdw": float(s["sdw"][i]),
                         "sld": float(s["sld"][i]), "sdd": float(s["sdd"][i]),
                         "sda": float(30 * cnt[i]), "c": int(cnt[i])}
                        for i, k in enumerate(uk)]
    # s5: the zone's offset per distinct date (its midnight in UTC)
    odate = od["odate"].astype(np.int64)
    cut = ((datetime.date(1995, 3, 15) - epoch).days * 86_400 + 43_200)
    sel = odate * 86_400 < cut
    udays = np.unique(odate[sel])
    tz = zoneinfo.ZoneInfo(zone) if not zone.startswith(("+", "-")) else \
        datetime.timezone(datetime.timedelta(hours=int(zone[1:3]),
                                             minutes=int(zone[4:6]))
                          * (1 if zone[0] == "+" else -1))

    def utc_at(day):
        return datetime.datetime(1970, 1, 1, tzinfo=utc) + \
            datetime.timedelta(days=int(day))

    def wall(day):  # from_utc_timestamp: the wall clock read as UTC
        at = utc_at(day)
        return at + at.astimezone(tz).utcoffset()

    def to_utc(day):  # to_utc_timestamp: the wall clock in the zone
        naive = datetime.datetime(1970, 1, 1) + \
            datetime.timedelta(days=int(day))
        local = naive.replace(tzinfo=tz, fold=0)
        return utc_at(day) - local.utcoffset()
    hour_at = np.zeros(int(udays.max() - udays.min()) + 1, np.int64)
    for u in udays:
        hour_at[int(u - udays.min())] = wall(u).hour
    refs["s5_timestamps"] = [{
        "n": int(sel.sum()),
        "sh": int(hour_at[odate[sel] - udays.min()].sum()),
        "mf": datetime.datetime(1970, 1, 1, tzinfo=utc) +
        datetime.timedelta(seconds=int(od["okey"][sel].min())),
        "mt": max(to_utc(u) for u in udays),
        "mw": min(wall(u) for u in udays)}]
    # s6: integral arithmetic (positive keys: pmod is %)
    ok = li["okey"]
    pm = ok % 7
    s = grouped(pm, 7, sr=(ok % 97).astype(np.float64),
                sq=(ok // 1000).astype(np.float64),
                slg=np.minimum(li["tax"], li["disc"]),
                sgr=np.maximum(li["qty"], li["tax"] * 100.0))
    cnt = np.bincount(pm, minlength=7)
    refs["s6_integral"] = [{"pm": int(i), "sr": float(s["sr"][i]),
                            "sq": float(s["sq"][i]), "slg": float(s["slg"][i]),
                            "sgr": float(s["sgr"][i]), "c": int(cnt[i])}
                           for i in range(7) if cnt[i]]
    # s7: q6's shape with a cast, an abs and a greatest in the filter
    m = ((ship >= (datetime.date(1994, 1, 1) - epoch).days)
         & (ship < (datetime.date(1995, 1, 1) - epoch).days)
         & (np.trunc(li["qty"]).astype(np.int64) < 24)
         & (np.abs(li["disc"] - 0.06) <= 0.011)
         & (np.maximum(li["tax"], 0.02) < 0.08))
    refs["s7_fused"] = [{"revenue": float(np.sum(li["price"][m]
                                                 * li["disc"][m])),
                         "n": int(m.sum())}]
    # s8: math
    t, q, dsc = li["tax"], li["qty"], li["disc"]
    refs["s8_math"] = [{
        "a": float(np.sum(np.sqrt(li["price"]))),
        "b": float(np.sum(np.log(q))), "c": float(np.sum(np.exp(t))),
        "d": float(np.sum(dsc ** 2.0)),
        "e": int(np.sum(np.floor(q).astype(np.int64))),
        "f": int(np.sum(np.ceil(q).astype(np.int64))),
        "g": float(np.sum(np.sign(t - 0.04))),
        "h": float(np.sum(np.arctan2(t, dsc))),
        "i": float(np.sum(np.hypot(t, dsc)))}]
    # s9: XXH64 and Murmur3 of numpy's own
    xs = 0
    ms = 0
    seed64 = np.uint64(42)
    for s0 in range(0, len(ok), chunk):
        sl = slice(s0, s0 + chunk)
        h = numpy_xxhash64_long(np, ok[sl].astype(np.uint64),
                                np.full(len(ok[sl]), seed64))
        h = numpy_xxhash64_long(np, li["pkey"][sl].astype(np.uint64), h)
        xs += int((h.view(np.int64) % 1000).sum())
        flag = np.asarray([ord(v) for v in rf_u], np.int64)[rf[sl]]
        byte = np.where(flag >= 128, flag - 256, flag).astype(np.uint32)
        h1 = numpy_murmur3_step(np, byte, np.full(len(byte), np.uint32(42)))
        h1 = numpy_murmur3_fmix(np, h1, 1)
        h1 = numpy_murmur3_step(np, ship[sl].astype(np.int64).astype(
            np.uint32), h1)
        h1 = numpy_murmur3_fmix(np, h1, 4)
        ms += int((h1.view(np.int32).astype(np.int64) % 1000).sum())
    refs["s9_hashes"] = [{"x": xs, "m": ms, "n": len(ok)}]
    # s10: casts; the double -> string -> double round trip keeps every
    # value (the shortest decimal reads back to the double)
    day = datetime.date(1995, 3, 15)
    refs["s10_casts"] = [{
        "b": int(ok.sum()), "qrt": len(ok),
        "mn": str(epoch + datetime.timedelta(days=int(ship.min()))),
        "mx": str(epoch + datetime.timedelta(days=int(ship.max()))),
        "d": int((ship == (day - epoch).days).sum()), "n": len(ok)}]
    rows = [i for i in np.nonzero(li["pkey"] == SCALAR_SAMPLE_PARTKEY)[0]]
    sample = [{"l_orderkey": int(ok[i]), "l_quantity": float(q[i]),
               "qs": java_double_string(float(q[i])),
               "ds": str(epoch + datetime.timedelta(days=int(ship[i])))}
              for i in rows]
    refs["s10_sample"] = sorted(sample, key=lambda r: (r["l_orderkey"],
                                                       r["qs"].encode()))
    # s11: each flag's first and last row in the table's order
    rows = []
    for i, flag in sorted(enumerate(rf_u), key=lambda kv: kv[1].encode()):
        at = np.nonzero(rf == i)[0]
        if not len(at):
            continue
        a, b = at[0], at[-1]
        rows.append({"l_returnflag": flag, "f": int(ok[a]), "l": int(ok[b]),
                     "fd": epoch + datetime.timedelta(days=int(ship[a])),
                     "lp": float(li["price"][b]), "n": len(at)})
    refs["s11_first_last"] = rows
    return refs


def fused_filter(physical, ctx, nodes, label):
    """Checks the run of the physical plan ``physical`` (with its
    ExecContext ``ctx``): one HashAggregateExec's fused plan (B1) holds
    the query's filter as its predicate, with an expression of each
    type in ``nodes`` (names of expression classes), and no FilterExec
    ran. Returns the predicate's expression types."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec

    def execs(node):
        yield node
        for c in node.children:
            yield from execs(c)

    def types(e):
        yield type(e).__name__
        for c in e.children:
            yield from types(c)
    preds = [p.pred for x in execs(physical)
             if isinstance(x, HashAggregateExec)
             for p in x._pallas_plans.values() if p.pred is not None]
    check(len(preds) == 1, f"{label}: {len(preds)} fused plans hold a "
          "filter, not 1")
    found = set(types(preds[0]))
    check(set(nodes) <= found, f"{label}: the fused filter lacks "
          f"{sorted(set(nodes) - found)}")
    ran = [eid for eid in ctx.metrics if eid.startswith("FilterExec#")]
    check(not ran, f"{label}: {ran} ran beside the fused filter")
    return found


def run_scalar(torch, dev, session, read_counts, name, text, must):
    """One scalar query through session.sql: a first run with every
    B1 / B3 launch held against the plain version, and WARM_RUNS warm
    runs outside the hold with the same launch counts; each kernel in
    ``must`` launched. Returns (its numbers, (text, columns, first
    run's rows, [each warm run's rows]))."""
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    DK.reset_counts()
    with holding_launches(torch, DK) as hold:
        t = time.perf_counter()
        df = session.sql(text)
        rows = df.collect()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
    counts = read_counts()
    check_held(hold, counts, f"scalar {name}")
    for k in must:
        check(counts[k] > 0, f"scalar {name}: {k} did not run")
    out = {}
    if name == "s7_fused":
        out["fused_filter"] = sorted(fused_filter(
            *session._last_execution, S7_FUSED_NODES, f"scalar {name}"))
    again, walls = [], []
    for _ in range(WARM_RUNS):
        DK.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        again.append(session.sql(text).collect())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        check(read_counts() == counts, f"scalar {name}: the warm run "
              f"launched {read_counts()}, the first {counts}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    out |= {"first_s": first,
            "warm_s": statistics.median(walls) if walls else None,
            "peak_gb": peak, "result_rows": len(rows), "launches": counts,
            "held": dict(hold.held), "max_abs_err": dict(hold.err)}
    log(f"scalar {name}: first {first:.4f} s (B1 / B3 held on every "
        f"launch), {warm_note(walls)}; launches {counts}; held B1 "
        f"{hold.held['tile_reduce']} / B3 {hold.held['tile_group_reduce']} "
        f"batches (max_abs_err {hold.err}); max_memory_allocated "
        f"{peak:.3f} GB" + (f"; B1's fused filter holds "
                            f"{out['fused_filter']}" if "fused_filter" in out
                            else ""))
    return out, (text, df.columns, rows, again)


def scalar_zone():
    """The zone the time-zone query converts through: SCALAR_ZONE, or
    SCALAR_FIXED_ZONE where the machine has no tz database; and why."""
    try:
        import zoneinfo
        zoneinfo.ZoneInfo(SCALAR_ZONE)
    except (ImportError, KeyError, OSError) as e:  # no tz database
        return SCALAR_FIXED_ZONE, (
            f"zoneinfo cannot resolve {SCALAR_ZONE} on this machine "
            f"({type(e).__name__}: {e}); the time-zone query uses the fixed "
            f"offset {SCALAR_FIXED_ZONE}")
    return SCALAR_ZONE, (f"zoneinfo resolves {SCALAR_ZONE} here; the "
                         "time-zone query uses it")


def scalar_phase(torch, np, dev, session, dfs, zone, worker, read_counts):
    """Phase 5b: scalar_queries through session.sql on the TPC-H tables
    already on the card (60M lineitem, 15M orders, 1.5M customer rows):
    a first run, with every B1 / B3 launch held against the plain
    version (``holding_launches``), and WARM_RUNS warm runs outside the
    hold, each held against scalar_references (from ``worker``, a
    ``host_worker`` process); logs walls, the device memory peak, each query's launches
    and its held B1 / B3 batches."""
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.testing import compare_rows, order_keys
    for name, df in dfs.items():
        session.create_or_replace_temp_view(name, df)
    report, results = {}, {}
    for name, (text, must) in scalar_queries(zone).items():
        report[name], results[name] = run_scalar(
            torch, dev, session, read_counts, name, text, must)
    t = time.perf_counter()
    refs, lanes_s, ref_s, worker_s = worker.get("scalar")
    log(f"scalar: numpy / Python references in {ref_s:.1f} s in a second "
        f"process, after its host lanes ({lanes_s:.1f} s), ready "
        f"{worker_s:.1f} s after it began (waited "
        f"{time.perf_counter() - t:.1f} s after the queries)")
    for name, (text, columns, rows, again) in results.items():
        keys, limit = order_keys(text, columns)
        diff = compare_rows(rows, refs[name], keys, limit, RTOL)
        check(diff is None, f"scalar {name}: {diff} (reference)")
        for warm in again:
            check(compare_rows(warm, refs[name], keys, limit, RTOL) is None,
                  f"scalar {name}: a warm run disagrees with the reference")
        log(f"scalar {name}: the first run and {len(again)} warm runs match "
            f"the reference ({len(rows)} rows)")
    n_li = -(-ROWS // BATCH_ROWS)
    check(report["s7_fused"]["launches"]["tile_reduce"] == n_li,
          f"scalar s7_fused: B1 ran on "
          f"{report['s7_fused']['launches']['tile_reduce']} of {n_li} "
          "batches")
    log("scalar summary " + json.dumps({q: {
        k: r[k] for k in ("first_s", "warm_s", "peak_gb", "result_rows")}
        | {"b1": r["launches"]["tile_reduce"],
           "b3": r["launches"]["tile_group_reduce"]}
        for q, r in report.items()}))
    return report


# --- phase 5c: the DECIMAL type ----------------------------------------------

#: the money columns typed DECIMAL(12,2), as Spark's TPC-H schemas type
#: them (databricks spark-sql-perf TPCH.scala; TPC-H clause 1.4)
DECIMAL_MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "o_totalprice")
#: D4 runs over lineitem's first rows only, so that its Python reference
#: (per-row Python ints) stays inside half a minute in its process
DECIMAL_D4_ROWS = 1 << 22
#: D6: one RetryOOM and one SplitAndRetryOOM, at the middle allocation
#: attempt of the clean run
DECIMAL_Q1 = """
    SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty,
           SUM(l_extendedprice) AS sum_base_price,
           SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
           SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax))
               AS sum_charge,
           AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price,
           AVG(l_discount) AS avg_disc, COUNT(*) AS count_order
    FROM lineitem WHERE l_shipdate <= date '1998-09-02'
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus"""
DECIMAL_Q1_TYPES = {"sum_qty": (22, 2), "sum_base_price": (22, 2),
                    "sum_disc_price": (36, 4), "sum_charge": (38, 6),
                    "avg_qty": (16, 6), "avg_price": (16, 6),
                    "avg_disc": (16, 6)}
DECIMAL_Q6 = """
    SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem
    WHERE l_shipdate >= date '1994-01-01' AND l_shipdate < date '1995-01-01'
      AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""
DECIMAL_Q3 = """
    SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15'
      AND l_shipdate > date '1995-03-15'
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate LIMIT 10"""
#: the exact 256-bit divide (DECIMAL(27,15)), round, four casts and a
#: product chain past 38 digits on most rows (price^7 needs 35 integral
#: digits at price 1e5; DECIMAL(38,6) holds 32)
DECIMAL_D4 = """
    SELECT l_extendedprice / l_quantity AS q,
           ROUND(l_extendedprice / l_quantity, 2) AS r,
           CAST(l_extendedprice AS DOUBLE) AS f,
           CAST(l_extendedprice AS BIGINT) AS b,
           CAST(l_extendedprice AS DECIMAL(38,10)) AS w,
           CAST(l_quantity AS STRING) AS s,
           l_extendedprice * l_extendedprice * l_extendedprice
             * l_extendedprice * l_extendedprice * l_extendedprice
             * l_extendedprice AS ovf
    FROM lineitem"""
DECIMAL_D4_TYPES = {"q": (27, 15), "r": (15, 2), "w": (38, 10),
                    "ovf": (38, 6)}
#: D5: ss_net_paid as DECIMAL(7,2), as TPC-DS defines it
DECIMAL_D5 = f"""
    SELECT ss_customer_sk, ss_net_paid,
           SUM(ss_net_paid) OVER (PARTITION BY ss_customer_sk
                                  ORDER BY {WINDOW_KEYS}
                                  ROWS BETWEEN UNBOUNDED PRECEDING
                                  AND CURRENT ROW) AS run_paid,
           AVG(ss_net_paid) OVER (PARTITION BY ss_customer_sk) AS avg_paid
    FROM store_sales_dec"""


def decimal_batches(torch, batches, names=DECIMAL_MONEY, precision=12):
    """The card's batches with the columns ``names`` as DECIMAL(p,2)
    lanes made on the card from the float lanes already there: x 100 in
    float64, truncated toward zero (the JAX datagen's bytes for a
    decimal column); the other columns are the same tensors."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                        ColumnarBatch)
    t = dt.DecimalType(precision, 2)
    out = []
    for b in batches:
        cols = [ColumnVector(torch.where(c.validity,
                                         (c.data * 100.0).to(torch.int64), 0),
                             c.validity, t) if n in names else c
                for n, c in zip(b.names, b.columns)]
        out.append(ColumnarBatch(cols, b.names, b.num_rows, b.device))
    return out


def _dec(v, scale):
    import decimal
    return decimal.Decimal(int(v)).scaleb(
        -scale, context=decimal.Context(prec=80))


def _half_up_div(num, den):
    """HALF_UP num / den for Python ints (den > 0)."""
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return -q if num < 0 else q


def decimal_references(np, li, od, cu):
    """D1-D4's exact references from the host lanes: the money lanes as
    unscaled int64 (x 100, truncated), sums in int64 (each group's
    fits at this scale), AVG and the divide HALF_UP in Python ints."""
    d = {k: (li[k] * 100).astype(np.int64) for k in ("qty", "price",
                                                      "disc", "tax")}
    out = {}
    # D1
    m = li["ship"] <= days(1998, 9, 2)
    rf = li["rf"].chars[li["rf"].offsets[:-1]]
    ls = li["ls"].chars[li["ls"].offsets[:-1]]
    code = rf[m].astype(np.int64) * 256 + ls[m]
    keys, g = np.unique(code, return_inverse=True)
    order = np.argsort(g, kind="stable")
    starts = np.r_[0, np.nonzero(np.diff(g[order]))[0] + 1]
    qty, price = d["qty"][m][order], d["price"][m][order]
    disc, tax = d["disc"][m][order], d["tax"][m][order]
    disc_price = price * (100 - disc)
    cols = {"sum_qty": (qty, 2), "sum_base_price": (price, 2),
            "sum_disc_price": (disc_price, 4),
            "sum_charge": (disc_price * (100 + tax), 6)}
    sums = {n: [int(x) for x in np.add.reduceat(v, starts)]
            for n, (v, _) in cols.items()}
    avg_in = {"avg_qty": qty, "avg_price": price, "avg_disc": disc}
    avg_sums = {n: [int(x) for x in np.add.reduceat(v, starts)]
                for n, v in avg_in.items()}
    counts = np.diff(np.r_[starts, len(g)])
    rows = []
    for i, k in enumerate(keys):
        r = {"l_returnflag": chr(k // 256), "l_linestatus": chr(k % 256)}
        r.update({n: _dec(sums[n][i], cols[n][1]) for n in cols})
        r.update({n: _dec(_half_up_div(avg_sums[n][i] * 10 ** 4,
                                       int(counts[i])), 6)
                  for n in avg_in})
        r["count_order"] = int(counts[i])
        rows.append(r)
    out["d1"] = rows
    # D2: the BETWEEN over doubles, as both packages type 0.05
    m = ((li["ship"] >= days(1994, 1, 1)) & (li["ship"] < days(1995, 1, 1))
         & (d["disc"] / 100.0 >= 0.05) & (d["disc"] / 100.0 <= 0.07)
         & (d["qty"] < 2400))
    out["d2"] = [{"revenue": _dec(int(np.sum(d["price"][m] * d["disc"][m])),
                                  4)}]
    # D3
    cutoff = days(1995, 3, 15)
    ckeys = np.sort(cu["ckey"][host_match(np, cu["seg"], b"BUILDING")])
    om = od["odate"] < cutoff
    okey, ockey, odate = od["okey"][om], od["ckey"][om], od["odate"][om]
    at = np.minimum(np.searchsorted(ckeys, ockey), max(len(ckeys) - 1, 0))
    hit = ckeys[at] == ockey
    okey, odate = okey[hit], odate[hit]
    o_order = np.argsort(okey, kind="stable")
    okey, odate = okey[o_order], odate[o_order]
    lm = li["ship"] > cutoff
    lkey = li["okey"][lm]
    rev = d["price"][lm] * (100 - d["disc"][lm])
    at = np.minimum(np.searchsorted(okey, lkey), max(len(okey) - 1, 0))
    hit = okey[at] == lkey
    lkey, rev = lkey[hit], rev[hit]
    l_order = np.argsort(lkey, kind="stable")
    lkey, rev = lkey[l_order], rev[l_order]
    gstart = np.r_[0, np.nonzero(np.diff(lkey))[0] + 1]
    groups, gsum = lkey[gstart], np.add.reduceat(rev, gstart)
    gdate = odate[np.searchsorted(okey, groups)]
    top = np.lexsort((gdate, -gsum))[:10]
    epoch = datetime.date(1970, 1, 1)
    out["d3"] = [{"l_orderkey": int(groups[i]), "revenue": _dec(gsum[i], 4),
                  "o_orderdate": epoch + datetime.timedelta(
                      days=int(gdate[i])), "o_shippriority": 0}
                 for i in top]
    out["d3_ties"] = int(np.sum((gsum == gsum[top[-1]])
                                & (gdate == gdate[top[-1]])))
    # D4 over the first rows
    n = DECIMAL_D4_ROWS
    price = d["price"][:n].astype(object)
    qty = d["qty"][:n].astype(object)
    q = (2 * price * 10 ** 15 + qty) // (2 * qty)      # all positive
    ten13 = 10 ** 13
    chain = price * price * price                        # scale 6
    ok = np.ones(n, bool)
    for _ in range(4):
        chain = (2 * (chain * price) + 100) // 200       # scale 8 -> 6
        ok &= chain < 10 ** 38
        chain = np.where(ok, chain, 0)
    qv = d["qty"][:n]
    out["d4"] = {
        "q": (q, np.ones(n, bool)),
        "r": ((2 * q + ten13) // (2 * ten13), np.ones(n, bool)),
        "f": (d["price"][:n] / 100.0, np.ones(n, bool)),
        "b": (d["price"][:n] // 100, np.ones(n, bool)),
        "w": (d["price"][:n] * 10 ** 8, np.ones(n, bool)),
        "s": (np.array([f"{v // 100}.{v % 100:02d}" for v in qv.tolist()],
                       object), np.ones(n, bool)),
        "ovf": (chain, ok)}
    return out


def decimal_window_reference(np, ref):
    """D5 in numpy int64 on every row, in table order: the running SUM of
    the unscaled cents over (customer; date, ticket, item), stable, nulls
    first, and each customer's AVG, HALF_UP at scale 6."""
    cols = {c: ref.col("store_sales", c) for c in (
        "ss_customer_sk", "ss_sold_date_sk", "ss_ticket_number",
        "ss_item_sk", "ss_net_paid")}
    keys = [np.where(ok, v, -1).astype(np.int64) for v, ok in (
        cols[c] for c in ("ss_customer_sk", "ss_sold_date_sk",
                          "ss_ticket_number", "ss_item_sk"))]
    n = len(keys[0])
    order = stable_order(np, keys)
    new_part = np.r_[True, keys[0][order][1:] != keys[0][order][:-1]]
    paid, pok = cols["ss_net_paid"]
    cents = np.where(pok, (np.asarray(paid) * 100).astype(np.int64), 0)
    s_cents, s_ok = cents[order], pok[order]
    starts = np.nonzero(new_part)[0]
    seg = np.cumsum(new_part) - 1
    cs = np.cumsum(s_cents)
    cc = np.cumsum(s_ok.astype(np.int64))
    base = (cs - s_cents)[starts][seg]
    base_c = (cc - s_ok)[starts][seg]
    run, run_n = cs - base, cc - base_c
    tot = np.add.reduceat(s_cents, starts)[seg]
    cnt = np.add.reduceat(s_ok.astype(np.int64), starts)[seg]
    avg = (2 * tot * 10 ** 4 + cnt) // np.maximum(2 * cnt, 1)
    want = {"ss_customer_sk": cols["ss_customer_sk"],
            "ss_net_paid": (cents, pok)}
    for name, (v, ok) in {"run_paid": (run, run_n > 0),
                          "avg_paid": (avg, cnt > 0)}.items():
        out_v, out_ok = np.empty_like(v), np.empty_like(ok)
        out_v[order], out_ok[order] = v, ok
        want[name] = (out_v, out_ok)
    return want, n


def same_decimal_rows(got, want):
    """Rows equal exactly (decimal.Decimal by value); nothing floats."""
    return len(got) == len(want) and all(
        g.keys() == w.keys() and all(g[k] == w[k] for k in w)
        for g, w in zip(got, want))


def run_decimal(torch, dev, session, read_counts, name, text, rows_in,
                collect=True):
    """A first run and WARM_RUNS warm runs of ``text`` through
    session.sql: walls, fact rows/s, the device memory peak and the
    transient part of it (peak minus what was resident before), the top
    operators' self times; no B1 / B3 launch may happen (their gates
    refuse decimal lanes). Returns (numbers, [each run's result, the
    first run's first])."""
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    results, walls = [], []
    for _ in range(1 + WARM_RUNS):
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        DK.reset_counts()
        t = time.perf_counter()
        df = session.sql(text)
        results.append(df.collect() if collect else df.to_table())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        counts = read_counts()
        check(not any(counts.values()), f"decimal {name}: launched "
              f"{counts}; no kernel gate admits a decimal lane")
    peak = torch.cuda.max_memory_allocated(dev)
    physical, ctx = session._last_execution
    self_ms = sorted(operator_self_ms(physical, ctx.metrics, {}).items(),
                     key=lambda kv: -kv[1])
    wall = statistics.median(walls[1:]) if WARM_RUNS else walls[0]
    out = {"first_s": walls[0], "warm_s": wall if WARM_RUNS else None,
           "rows": rows_in, "rows_per_s": rows_in / wall,
           "peak_gb": peak / 1e9, "transient_gb": (peak - resident) / 1e9,
           "schema": [(n, repr(t)) for n, t in df.schema]}
    log(f"decimal {name}: first {walls[0]:.4f} s, {warm_note(walls[1:])}, "
        f"{rows_in / wall:.4e} fact rows/s; max_memory_allocated "
        f"{peak / 1e9:.3f} GB, transient {(peak - resident) / 1e9:.3f} GB "
        "(the last run's); operator self time (host clock, ms, last run): "
        + ", ".join(f"{k} {v:.1f}" for k, v in self_ms[:6]))
    return out, results


def decimal_phase(torch, np, dev, batches, host, read_counts, worker):
    """Phase 5c: TPC-H over DECIMAL(12,2) money on the card (D1 q1, D2 q6,
    D3 q3 at 60M / 15M / 1.5M rows; D4 the casts and the exact divide
    over lineitem's first DECIMAL_D4_ROWS rows; D6 D1 under an injected
    RetryOOM and SplitAndRetryOOM, and a Decimal128Column's spill round
    trip), each held against ``decimal_references`` (from ``worker``, a
    ``host_worker`` process). Returns (report, the session, a function that runs
    D1, D1's reference)."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.decimal128 import Decimal128Column
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.memory.budget import task_context
    from spark_rapids_tpu_torch.memory.spill import SpillableBatch
    from spark_rapids_tpu_torch.plan.session import TpuSession
    t = time.perf_counter()
    before = torch.cuda.memory_allocated(dev)
    dec = {n: decimal_batches(torch, b) for n, b in batches.items()}
    torch.cuda.synchronize()
    log(f"decimal: DECIMAL(12,2) money lanes made on the card from the "
        f"float lanes in {time.perf_counter() - t:.2f} s, "
        f"{(torch.cuda.memory_allocated(dev) - before) / 1e9:.3f} GB more "
        "resident")
    session = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS}),
                         device=dev)
    for name, bs in dec.items():
        session.create_or_replace_temp_view(name, session.from_batches(bs))
    li_types = dict(session.table("lineitem").schema)
    check(li_types["l_extendedprice"] == dt.DecimalType(12, 2),
          f"lineitem types {li_types}")
    report, results = {}, {}
    for name, text, rows_in in (("d1_q1", DECIMAL_Q1, ROWS),
                                ("d2_q6", DECIMAL_Q6, ROWS),
                                ("d3_q3", DECIMAL_Q3, ROWS)):
        report[name], results[name] = run_decimal(
            torch, dev, session, read_counts, name, text, rows_in)
    types = dict(report["d1_q1"]["schema"])
    for col_name, (p, sc) in DECIMAL_Q1_TYPES.items():
        check(types[col_name] == f"decimal({p},{sc})",
              f"decimal d1: {col_name} is {types[col_name]}")
    check(dict(report["d3_q3"]["schema"])["revenue"] == "decimal(36,4)",
          f"decimal d3: {report['d3_q3']['schema']}")
    log(f"decimal d4: over lineitem's first {DECIMAL_D4_ROWS} rows (cut so "
        "that its per-row Python reference stays inside half a minute)")
    d4_session = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS}),
                            device=dev)
    d4_session.create_or_replace_temp_view(
        "lineitem", d4_session.from_batches(
            dec["lineitem"][:DECIMAL_D4_ROWS // BATCH_ROWS]))
    report["d4_casts"], d4_results = run_decimal(
        torch, dev, d4_session, read_counts, "d4_casts", DECIMAL_D4,
        DECIMAL_D4_ROWS, collect=False)
    d4_types = dict(report["d4_casts"]["schema"])
    for col_name, (p, sc) in DECIMAL_D4_TYPES.items():
        check(d4_types[col_name] == f"decimal({p},{sc})",
              f"decimal d4: {col_name} is {d4_types[col_name]}")
    # D6: injected OOMs in D1 (a RetryOOM at the middle allocation
    # attempt; SplitAndRetryOOMs at INJECTIONS attempts spread over the
    # run, until one lands where a batch halves), then one
    # Decimal128Column's spill round trip
    with memory_conf(torch, dev, session, {}):
        clean = session.sql(DECIMAL_Q1).collect()
        total = session._last_execution[1].memory["allocAttempts"]
        offsets = sorted({(total - 1) * (i + 1) // (INJECTIONS + 1)
                          for i in range(INJECTIONS)})
        injected = {"retry": {"at": [], "retries": 0, "splits": 0},
                    "split": {"at": [], "retries": 0, "splits": 0}}
        for mode, at in [("retry", total // 2)] + [("split", o)
                                                  for o in offsets]:
            if mode == "split" and injected["split"]["splits"]:
                break
            tc = task_context()
            if mode == "retry":
                tc.force_retry_oom(at)
            else:
                tc.force_split_and_retry_oom(at)
            got = session.sql(DECIMAL_Q1).collect()
            mem = dict(session._last_execution[1].memory)
            check(got == clean, f"decimal d6: the {mode} injected at {at} "
                  "differs from the clean run")
            check(mem["retryCount"] + mem["splitAndRetryCount"] >= 1,
                  f"decimal d6: the {mode} at {at} reached no retry or split")
            injected[mode]["at"].append(at)
            injected[mode]["retries"] += mem["retryCount"]
            injected[mode]["splits"] += mem["splitAndRetryCount"]
        check(injected["split"]["splits"] > 0, "decimal d6: no injected "
              f"split landed where a batch could be halved ({injected})")
    from spark_rapids_tpu_torch.columnar.vector import ColumnarBatch
    from spark_rapids_tpu_torch.expr.core import col as ref
    b0 = dec["lineitem"][0]
    price = ref("l_extendedprice")
    col = (price * price * price).eval(b0)
    batch = ColumnarBatch([col], ["cube"], b0.num_rows, dev)
    check(isinstance(col, Decimal128Column), f"decimal d6: {type(col)}")
    sb = SpillableBatch(batch)
    moved = {"host": sb.spill_to_host()}
    moved["disk"] = sb.spill_to_disk()
    back = sb.get().column("cube")
    check(torch.equal(back.hi, col.hi) and torch.equal(back.lo, col.lo)
          and torch.equal(back.validity, col.validity),
          "decimal d6: a Decimal128Column came back from disk changed")
    sb.close()
    report["d6_injected"] = {"alloc_attempts": total, **injected,
                             "spilled_bytes": moved}
    log(f"decimal d6: D1 ({total} allocation attempts) with a RetryOOM "
        f"and SplitAndRetryOOMs injected equals the clean run "
        f"({injected}); a {batch.num_rows}-row DECIMAL(38,6) batch spilled "
        f"to host and disk ({moved} bytes) came back bit-equal")
    t = time.perf_counter()
    refs, _, ref_s, _ = worker.get("decimal")
    log(f"decimal: references in {ref_s:.1f} s in a second process "
        f"(waited {time.perf_counter() - t:.1f} s)")
    for name, key in (("d1_q1", "d1"), ("d2_q6", "d2")):
        for run, rows in enumerate(results[name]):
            check(same_decimal_rows(rows, refs[key]),
                  f"decimal {name} run {run}: {rows} != {refs[key]}")
        log(f"decimal {name}: the first run and {len(results[name]) - 1} "
            f"warm runs equal the exact reference "
            f"{refs[key] if key == 'd2' else len(refs[key])}")
    check(same_decimal_rows(clean, refs["d1"]), "decimal d6: clean run")
    for label, rows in enumerate(results["d3_q3"]):
        got = [(r["revenue"], r["o_orderdate"]) for r in rows]
        want = [(r["revenue"], r["o_orderdate"]) for r in refs["d3"]]
        check(got == want, f"decimal d3_q3 run {label}: {got} != {want}")
        tail = [(r["revenue"], r["o_orderdate"]) for r in refs["d3"]]
        unique = [i for i, v in enumerate(tail) if tail.count(v) == 1
                  and not (i == 9 and refs["d3_ties"] > 1)]
        check(all(rows[i]["l_orderkey"] == refs["d3"][i]["l_orderkey"]
                  for i in unique), f"decimal d3_q3 run {label}: order keys")
    log(f"decimal d3_q3: revenue DECIMAL(36,4) top 10 sorted on the card "
        f"equals the exact reference ({refs['d3'][0]['revenue']} first)")
    for label, table in enumerate(d4_results):
        for c in table.columns:
            if c.dtype == dt.STRING:
                c.values = c.values.to_objects()
        same_columns(np, table, refs["d4"], f"decimal d4_casts run {label}")
    nulls = int((~refs["d4"]["ovf"][1]).sum())
    check(0 < nulls < DECIMAL_D4_ROWS, f"decimal d4: {nulls} overflow rows")
    report["d4_casts"]["overflow_nulls"] = nulls
    log(f"decimal d4_casts: every row equals the reference; the product "
        f"chain is NULL (past 38 digits) on {nulls} of {DECIMAL_D4_ROWS} "
        "rows")
    log("decimal summary " + json.dumps(report, default=str))

    def run_d1():
        return session.sql(DECIMAL_Q1).collect()
    return report, session, run_d1, refs["d1"]


def decimal_window_phase(torch, np, dev, session, read_counts, ahead):
    """D5: ss_net_paid as DECIMAL(7,2) over all store_sales rows: a ROWS
    running SUM (DECIMAL(17,2)) and a whole-partition AVG
    (DECIMAL(11,6)) per customer through two WindowExecs, held against
    numpy int64 scans on every row."""
    from spark_rapids_tpu_torch.exec.window import WindowExec
    rel = session.table("store_sales").plan
    keep = ("ss_customer_sk", "ss_sold_date_sk", "ss_ticket_number",
            "ss_item_sk", "ss_net_paid")
    bs = [b.select(list(keep)) for b in rel.batches]
    session.create_or_replace_temp_view("store_sales_dec", session.from_batches(
        decimal_batches(torch, bs, ("ss_net_paid",), precision=7)))
    t = time.perf_counter()
    try:
        want, rows = ahead.get("d5")
    finally:
        ahead.close()
    ref_s = time.perf_counter() - t
    report, tables = run_decimal(torch, dev, session, read_counts,
                                 "d5_window", DECIMAL_D5, rows,
                                 collect=False)
    types = dict(report["schema"])
    check(types["run_paid"] == "decimal(17,2)" and
          types["avg_paid"] == "decimal(11,6)", f"decimal d5: {types}")
    physical, _ = session._last_execution
    nodes, todo = [], [physical]
    while todo:
        nodes.append(todo.pop())
        todo.extend(nodes[-1].children)
    check(sum(isinstance(x, WindowExec) for x in nodes) == 2,
          f"decimal d5: ran {[type(x).__name__ for x in nodes]}")
    for run, table in enumerate(tables):
        same_columns(np, table, want, f"decimal d5_window run {run}")
    log(f"decimal d5_window: the first run and {len(tables) - 1} warm runs "
        f"equal numpy's int64 scans on all {rows} rows (waited "
        f"{ref_s:.1f} s for the reference)")
    return report


def profiled(torch, label, run):
    """One run under torch.profiler: its device time by kernel and
    the device's idle share; returns the run's rows."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the device's activity only: the host's op events are not
    # read here, and the profiler works through every event it
    # holds once the run ends
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rows = run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    kernel_us = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernel_us[e.key] = kernel_us.get(e.key, 0.0) + us
    busy = sum(kernel_us.values()) / 1e6
    if busy > 0:
        log(f"{label} profiled run: wall {prof_wall:.4f} s (profiler "
            f"on), device kernels {busy:.4f} s over {len(kernel_us)} "
            f"kernel names, idle share {1 - busy / prof_wall:.3f}")
        for name, us in sorted(kernel_us.items(),
                               key=lambda kv: -kv[1])[:12]:
            log(f"  {label} kernel {us / 1e3:9.3f} ms "
                f"{us / 1e4 / busy:5.1f}%  {name[:110]}")
    else:
        log(f"{label} profiled run: the profiler recorded no device "
            "time")
    return rows


# --- phase 5e: mixed device / CPU-engine plans ----------------------------

#: F6: TPC-H q6 and q1 with srt.sql.enabled=false over lineitem's first
#: 3,000,000 rows (half SF1's count; the CPU engine's Python loops would
#: take minutes over all 60M)
FALLBACK_F6_ROWS = 3_000_000


def _f6_reference(np, li, n):
    """q6 and q1 over lineitem's first ``n`` rows, in numpy."""
    ship, qty, price = li["ship"][:n], li["qty"][:n], li["price"][:n]
    disc, tax = li["disc"][:n], li["tax"][:n]
    m = (ship >= days(1994, 1, 1)) & (ship < days(1995, 1, 1)) & \
        (disc >= 0.05) & (disc <= 0.07) & (qty < 24.0)
    q6 = [{"revenue": float((price[m] * disc[m]).sum())}]
    keep = ship <= days(1998, 9, 2)
    flag = np.array([chr(b) for b in li["rf"].chars[li["rf"].offsets[:-1]]])
    status = np.array([chr(b) for b in li["ls"].chars[li["ls"].offsets[:-1]]])
    key = np.char.add(flag[:n], status[:n])
    q1 = []
    for k in sorted(set(key[keep])):
        g = keep & (key == k)
        dp = price[g] * (1.0 - disc[g])
        q1.append({"l_returnflag": k[0], "l_linestatus": k[1],
                   "sum_qty": float(qty[g].sum()),
                   "sum_base_price": float(price[g].sum()),
                   "sum_disc_price": float(dp.sum()),
                   "sum_charge": float((dp * (1.0 + tax[g])).sum()),
                   "avg_qty": float(qty[g].mean()),
                   "avg_price": float(price[g].mean()),
                   "avg_disc": float(disc[g].mean()),
                   "count_order": int(g.sum())})
    return q6, q1


def fallback_references(np, li, od):
    """F1-F4's and F6's references from the TPC-H host lanes, written
    from the query texts (models/fallback.py) in numpy and Python's re
    and decimal, independent of the port's code (a ``host_worker``
    job)."""
    import decimal
    import re as pyre
    out = {}
    # F1: regexp_replace over one quarter's orders, grouped
    m = (od["odate"] >= days(1995, 1, 1)) & (od["odate"] < days(1995, 4, 1))
    idx = np.nonzero(m)[0]
    prio = od["prio"].take(idx).to_objects()
    p = np.array([pyre.sub(r"(\w)(\w*)", r"\2\1", x, flags=pyre.ASCII)
                  for x in prio], dtype=object)
    uniq, inv = np.unique(p, return_inverse=True)
    n = np.bincount(inv, minlength=len(uniq))
    tot = np.bincount(inv, weights=od["total"][idx], minlength=len(uniq))
    out["f1"] = [{"p": u, "n": int(c), "total": float(t)}
                 for u, c, t in zip(uniq, n, tot)]
    # F2: q6's conjuncts for January 1994 and the decimal string's '5.'
    li_ship, qty, price, disc = li["ship"], li["qty"], li["price"], li["disc"]
    m = (li_ship >= days(1994, 1, 1)) & (li_ship < days(1994, 2, 1)) & \
        (disc >= 0.05) & (disc <= 0.07) & (qty < 24)
    idx = np.nonzero(m)[0]
    cent = decimal.Decimal("0.01")
    text = [format(decimal.Decimal(repr(float(x))).quantize(
        cent, decimal.ROUND_HALF_UP), "f") for x in price[idx]]
    keep = idx[np.array(["5." in t for t in text], bool)]
    out["f2"] = [{"revenue": float((price[keep] * disc[keep]).sum()),
                  "n": int(len(keep))}]
    # F3: DECIMAL(12,2) quantities (x 100 truncated, as decimal_batches
    # makes them) grouped at DECIMAL(20,2) for June 1995
    m = (li_ship >= days(1995, 6, 1)) & (li_ship < days(1995, 7, 1))
    qc = (qty[m] * 100.0).astype(np.int64)
    dc = (disc[m] * 100.0).astype(np.int64)
    uniq, inv = np.unique(qc, return_inverse=True)
    n = np.bincount(inv, minlength=len(uniq))
    dsum = np.zeros(len(uniq), np.int64)
    np.add.at(dsum, inv, dc)
    out["f3"] = [{"q": decimal.Decimal(int(q)).scaleb(-2),
                  "n": int(c), "disc": decimal.Decimal(int(d)).scaleb(-2)}
                 for q, c, d in zip(uniq, n, dsum)]
    # F4: January 1995's orders joined to the lineitems shipped in
    # January and February 1995, per priority
    om = (od["odate"] >= days(1995, 1, 1)) & (od["odate"] < days(1995, 2, 1))
    oi = np.nonzero(om)[0]
    okeys = od["okey"][oi]
    order = np.argsort(okeys, kind="stable")
    sk = okeys[order]
    lm = (li_ship >= days(1995, 1, 1)) & (li_ship < days(1995, 3, 1))
    lk, lq = li["okey"][lm], qty[lm]
    pos = np.searchsorted(sk, lk).clip(0, max(len(sk) - 1, 0))
    hit = (sk[pos] == lk) if len(sk) else np.zeros(len(lk), bool)
    prio = od["prio"].take(oi[order[pos[hit]]]).to_objects()
    uniq, inv = np.unique(prio, return_inverse=True)
    out["f4"] = [{"o_orderpriority": u, "n": int(c), "qty": float(t)}
                 for u, c, t in zip(uniq, np.bincount(inv, minlength=len(
                     uniq)), np.bincount(inv, weights=lq[hit],
                                         minlength=len(uniq)))]
    out["f6_q6"], out["f6_q1"] = _f6_reference(np, li, FALLBACK_F6_ROWS)
    return out


def f5_reference(np, nds_ref):
    """F5's reference from NdsNumpy: store_sales x item x date_dim for
    June 1999, stddev_samp of ss_net_paid per category, the largest
    brand per store."""
    dates = nds_ref.dates(d_year=1999, d_moy=6)
    idx, dims = nds_ref.fact_dims(
        "store_sales",
        [("ss_sold_date_sk", "date_dim", "d_date_sk", dates),
         ("ss_item_sk", "item", "i_item_sk", None)])
    cat = nds_ref.take("item", "i_category", dims["item"])
    brand = nds_ref.take("item", "i_brand", dims["item"])
    paid, paid_ok = nds_ref.take("store_sales", "ss_net_paid", idx)
    store = nds_ref.take("store_sales", "ss_store_sk", idx)
    gid, ng, _ = nds_ref.group([cat])
    w = paid_ok.astype(np.float64)
    x = np.where(paid_ok, paid, 0.0).astype(np.float64)
    cnt = np.bincount(gid, weights=w, minlength=ng)
    mean = np.bincount(gid, weights=x, minlength=ng) / np.maximum(cnt, 1)
    m2 = np.bincount(gid, weights=w * (x - mean[gid]) ** 2, minlength=ng)
    sd = np.sqrt(m2 / np.maximum(cnt - 1, 1))
    sgid, ns, _ = nds_ref.group([store])
    best = [None] * ns
    for g, b, ok in zip(sgid, brand[0], brand[1]):
        if ok and (best[g] is None or b > best[g]):
            best[g] = b
    return {
        "ticket": nds_ref.take("store_sales", "ss_ticket_number", idx)[0],
        "item": nds_ref.take("store_sales", "ss_item_sk", idx)[0],
        "category": np.where(cat[1], cat[0], None),
        "sd": sd[gid], "sd_ok": cnt[gid] >= 2,
        "brand": np.array([best[g] for g in sgid], dtype=object)}


def same_f5(np, table, want):
    """F5's rows against its reference, both in (ticket, item, sd,
    brand) order."""
    got = {n: c for n, c in zip(table.names, table.columns)}
    tick, item = got["ss_ticket_number"], got["ss_item_sk"]
    check(table.num_rows == len(want["ticket"]),
          f"F5: {table.num_rows} rows, reference {len(want['ticket'])}")
    cat = got["i_category"].values.to_objects()
    cat = np.where(got["i_category"].mask, cat, None)
    brand = got["top_brand"].values.to_objects()
    brand = np.where(got["top_brand"].mask, brand, None)
    sd, sd_ok = got["sd"].values, got["sd"].mask

    def order(t, i, s, b):
        return np.lexsort((np.array([str(v) for v in b], dtype=object)
                           .astype(str), np.round(s, 6), i, t))
    g = order(tick.values, item.values, np.where(sd_ok, sd, -1.0), brand)
    r = order(want["ticket"], want["item"],
              np.where(want["sd_ok"], want["sd"], -1.0), want["brand"])
    check(np.array_equal(tick.values[g], want["ticket"][r]) and
          np.array_equal(item.values[g], want["item"][r]),
          "F5: the (ticket, item) rows differ")
    check(np.array_equal(sd_ok[g], want["sd_ok"][r]), "F5: NULL sd differ")
    a, b = sd[g][sd_ok[g]], want["sd"][r][want["sd_ok"][r]]
    check(bool(np.all(np.abs(a - b) <= RTOL * np.abs(b))),
          "F5: stddev_samp differs past rtol")
    check(bool(np.all(cat[g] == want["category"][r])) and
          bool(np.all(brand[g] == want["brand"][r])),
          "F5: category or brand differ")


def fallback_phase(torch, np, dev, sessions, li_batches, read_counts,
                   worker, nds_ref):
    """Phase 5e: F1-F6 (models/fallback.py) on the resident SF10 tables:
    each plan's CPU-engine nodes against the ones the query names, a
    first run with every B1 / B3 launch held against the plain version,
    WARM_RUNS warm runs, each against ``fallback_references`` (from
    ``worker``, a ``host_worker`` process) and ``f5_reference``; logs
    walls, the rows and bytes across each seam and the seconds in the
    CPU engine against the rest (the device, host clock)."""
    from spark_rapids_tpu_torch.columnar.vector import ColumnarBatch
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models import fallback as FB
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.session import TpuSession
    from spark_rapids_tpu_torch.testing import compare_rows
    # F6: a session with the device turned off over the first 3M rows
    per = BATCH_ROWS
    cut = []
    for b in li_batches:
        left = FALLBACK_F6_ROWS - sum(c.num_rows for c in cut)
        if left <= 0:
            break
        cut.append(b if b.num_rows <= left else
                   ColumnarBatch(b.columns, b.names, left, b.device))
    off = TpuSession(SrtConf({"srt.sql.batchSizeRows": per,
                              "srt.sql.enabled": False}), device=dev)
    off_li = off.from_batches(cut)
    t = time.perf_counter()
    want, _, ref_s, _ = worker.get("fallback")
    waited = time.perf_counter() - t
    t = time.perf_counter()
    want["f5"] = f5_reference(np, nds_ref)
    log(f"fallback: references in {ref_s:.1f} s in a second process "
        f"(waited {waited:.1f} s), F5's {time.perf_counter() - t:.1f} s "
        "here")
    runs = {
        "f1": (sessions["float"], lambda: sessions["float"].sql(FB.F1),
               {"tile_group_reduce": 1}),
        "f2": (sessions["float"], lambda: sessions["float"].sql(FB.F2),
               {"tile_reduce": 1}),
        "f3": (sessions["decimal"], lambda: sessions["decimal"].sql(FB.F3),
               {}),
        "f4": (sessions["float"], lambda: sessions["float"].sql(FB.F4),
               {"tile_group_reduce": 1}),
        "f5": (sessions["nds"], lambda: sessions["nds"].sql(FB.F5), {}),
        "f6_q6": (off, lambda: tpch.q6(off_li), {}),
        "f6_q1": (off, lambda: tpch.q1(off_li), {}),
    }
    report = {}
    for name, (session, make, at_least) in runs.items():
        df = make()
        marks = FB.not_on_device(df.explain("NOT_ON_TPU").splitlines())
        expect = FB.CPU_NODES.get(name, [])
        check(marks == expect, f"fallback {name}: CPU-engine nodes {marks}, "
              f"expected {expect}")
        walls, outs = [], []
        for run in range(1 + WARM_RUNS):
            DK.reset_counts()
            torch.cuda.synchronize()
            hold = holding_launches(torch, DK) if run == 0 else None
            t = time.perf_counter()
            if hold is not None:
                with hold:
                    out = df.to_table() if name == "f5" else df.collect()
            else:
                out = df.to_table() if name == "f5" else df.collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            counts = read_counts()
            if hold is not None:
                check_held(hold, counts, f"fallback {name}")
                first_counts, first_err = counts, dict(hold.err)
            for key, n in at_least.items():
                check(counts[key] >= n, f"fallback {name}: {key} launched "
                      f"{counts[key]} times, expected at least {n}")
            if name.startswith("f6"):
                check(sum(counts.values()) == 0,
                      f"fallback {name}: launched {counts} with the device "
                      "turned off")
            outs.append(out)
        totals = session._last_execution[1].metric_totals()
        for out in outs:
            if name == "f5":
                same_f5(np, out, want["f5"])
            else:
                diff = compare_rows(out, want[name], [], None, RTOL)
                check(diff is None, f"fallback {name}: {diff}")
        cpu_s = totals.get("cpuTimeNs", 0) / 1e9
        seam_s = totals.get("transitionTimeNs", 0) / 1e9
        report[name] = {
            "first_s": walls[0],
            "warm_s": statistics.median(walls[1:]) if WARM_RUNS else None,
            "seam_rows": totals.get("transitionRows", 0),
            "seam_bytes": totals.get("transitionBytes", 0),
            "seam_s": seam_s, "cpu_engine_s": cpu_s,
            "rest_s": walls[-1] - cpu_s - seam_s,
            "launches": first_counts, "max_abs_err": first_err,
            "cpu_nodes": marks}
        log(f"fallback {name}: CPU-engine nodes {marks}; matches the "
            f"reference; walls first {walls[0]:.3f} s, "
            f"{warm_note(walls[1:])}; seams (last run) "
            f"{report[name]['seam_rows']} rows, "
            f"{report[name]['seam_bytes']} B, {seam_s:.3f} s; CPU engine "
            f"{cpu_s:.3f} s, the rest (device and planning, host clock) "
            f"{report[name]['rest_s']:.3f} s; launches {first_counts}")
    log("fallback summary " + json.dumps(report))
    return report


# --- phase 5d: nested types, higher-order functions, JSON -----------------

#: orders_json's documents: the first 4,194,304 orders (a Python
#: f-string a document takes about 5 us on a host core, so all 15M would
#: take about 75 s to build, past the 60 s this phase allows it)
NESTED_JSON_ROWS = 1 << 22
#: rows per orders_json batch: the JSON scan keeps about ten int64 lanes
#: per byte on the card while a batch runs
NESTED_JSON_BATCH = 1 << 18


def nested_host_tables(np, host):
    """lineitem and orders as the port's host tables, over the host
    lanes main keeps (no copy)."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    li, od = host["lineitem"], host["orders"]

    def table(cols):
        return HostTable([HostColumn(v, np.ones(len(v), bool), t)
                          for _, (v, t) in cols.items()], list(cols))
    return table({"l_orderkey": (li["okey"], dt.INT64),
                  "l_quantity": (li["qty"], dt.FLOAT64),
                  "l_extendedprice": (li["price"], dt.FLOAT64),
                  "l_discount": (li["disc"], dt.FLOAT64),
                  "l_shipdate": (li["ship"], dt.DATE),
                  "l_returnflag": (li["rf"], dt.STRING)}), \
        table({"o_totalprice": (od["total"], dt.FLOAT64),
               "o_orderpriority": (od["prio"], dt.STRING)})


def nested_same(got, want):
    """A result row against its reference: floats to RTOL, NaN equal."""
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            nested_same(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return isinstance(got, (list, tuple)) and len(got) == len(want) \
            and all(nested_same(g, w) for g, w in zip(got, want))
    if isinstance(want, float) and isinstance(got, float):
        return (got != got and want != want) or \
            abs(got - want) <= RTOL * abs(want)
    return got == want


def nested_host_build(np, host):
    """orders_nested on the host: (lineitem's host table, the
    NestedOrders, its host table, the seconds the build took)."""
    from spark_rapids_tpu_torch.models import nested as NM
    t = time.perf_counter()
    li_t, _ = nested_host_tables(np, host)
    no = NM.NestedOrders(li_t)
    return li_t, no, no.table(), time.perf_counter() - t


def nested_phase(torch, np, dev, session, li_df, built, worker,
                 read_counts):
    """Phase 5d: ``orders_nested`` (lineitem stably sorted on l_orderkey
    and cut into orders of 1-7 lines: 60M elements in each of five
    arrays over about 15M orders) built on the host (``built``'s
    "nested_host" entry, ``nested_host_build`` on a host thread during
    the phases before) and moved to the card
    through the flat host lanes in 1,048,576-row batches, and
    ``orders_json`` (NESTED_JSON_ROWS documents, from ``worker``); N1-N7
    of models/nested.py, each a first run with every B1 / B3 launch held
    and WARM_RUNS warm runs, held against numpy segment reductions over the
    sorted host lanes, computed on a host thread beside the queries (N6
    against Python's json, in ``worker``). Returns (report, N2's run, N2's
    reference, the resident DataFrames' batches) for phase 8's profile."""
    from spark_rapids_tpu_torch.expr import higher_order as HO
    from spark_rapids_tpu_torch.models import nested as NM
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    t = time.perf_counter()
    try:
        li_t, no, nt, build_s = built.get("nested_host")
    finally:
        built.close()
    build_wait = time.perf_counter() - t
    # the numpy references on one host thread from here
    ahead = references_ahead([
        ("nested", lambda: NM.references(no, li_t)),
        ("n3_rows", lambda: NM.n3_rows_reference(no))])
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        on_batches = [table_to_batch(nt.slice(s, s + BATCH_ROWS),
                                     device=dev)
                      for s in range(0, no.n, BATCH_ROWS)]
        torch.cuda.synchronize()
        move_s = time.perf_counter() - t
        nested_gb = (torch.cuda.memory_allocated(dev) - before) / 1e9
        log(f"nested: orders_nested {no.n} orders, {len(no.row)} elements "
            f"in each of price / disc / qty / ship / flags (longest "
            f"{int(no.lens.max())}, one price array in "
            f"{NM.NULL_PRICE_EVERY} NULL); host build {build_s:.1f} s on "
            f"a host thread (waited {build_wait:.1f} s), "
            f"moved in {move_s:.1f} s as {len(on_batches)} batches, "
            f"{nested_gb:.3f} GB on the card")
        t = time.perf_counter()
        (jt, n_orders), _, docs_s, _ = worker.get("orders_json")
        check(n_orders == no.n, f"nested: a second process made "
              f"{n_orders} orders, this one {no.n}")
        n_docs = len(jt.columns[0])
        doc_bytes = int(jt.columns[0].values.offsets[-1])
        wait_s = time.perf_counter() - t
        before = torch.cuda.memory_allocated(dev)
        json_batches = [table_to_batch(jt.slice(s, s + NESTED_JSON_BATCH),
                                       device=dev)
                        for s in range(0, n_docs, NESTED_JSON_BATCH)]
        torch.cuda.synchronize()
        log(f"nested: orders_json {n_docs} documents of the first orders "
            f"(cut from {no.n}: their build would pass the 60 s allowed), "
            f"{doc_bytes} bytes (longest "
            f"{int(jt.columns[0].values.lengths().max())}), "
            f"built in {docs_s:.1f} s in a second process (waited "
            f"{wait_s:.1f} s), "
            f"{(torch.cuda.memory_allocated(dev) - before) / 1e9:.3f} GB on "
            f"the card in {len(json_batches)} batches")
        del jt
        on = session.from_batches(on_batches)
        session.create_or_replace_temp_view(
            "orders_json", session.from_batches(json_batches))
        queries = NM.queries(NM.port_api(), on, li_df)
        runs = {k: (lambda q=q: q.collect()) for k, q in queries.items()}
        runs["N6"] = lambda: session.sql(NM.N6_SQL).collect()
        elements = {"N6": n_docs, "N7": len(li_t.columns[0])}
        report, results = {}, {}
        for name, run in runs.items():
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            DK.reset_counts()
            HO.FOLD_STEPS["steps"] = 0
            with holding_launches(torch, DK) as hold:
                t = time.perf_counter()
                rows = run()
                torch.cuda.synchronize()
                first = time.perf_counter() - t
            counts = read_counts()
            check_held(hold, counts, f"nested {name}")
            steps = HO.FOLD_STEPS["steps"]
            if name in ("N1", "N6"):
                check(counts["tile_group_reduce"] > 0,
                      f"nested {name}: B3 did not run ({counts})")
            again, walls = [], []
            for _ in range(WARM_RUNS):
                DK.reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                again.append(run())
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                check(read_counts() == counts, f"nested {name}: the warm "
                      f"run launched {read_counts()}, the first {counts}")
            wall = statistics.median(walls) if walls else first
            peak = torch.cuda.max_memory_allocated(dev)
            n_el = elements.get(name, len(no.row))
            report[name] = {
                "first_s": first, "warm_s": wall if walls else None,
                "elements_per_s": n_el / wall, "peak_gb": peak / 1e9,
                "transient_gb": (peak - resident) / 1e9,
                "launches": counts, "fold_steps": steps,
                "held": dict(hold.held), "max_abs_err": dict(hold.err)}
            results[name] = (rows, again)
            log(f"nested {name}: first {first:.4f} s (B1 / B3 held), "
                f"{warm_note(walls)}, {n_el / wall:.4e} "
                f"{'documents' if name == 'N6' else 'elements'}/s (the "
                f"{'warm median' if walls else 'first run'}); launches "
                f"{counts}" + (f"; aggregate fold steps {steps}" if steps
                               else "") + f"; peak {peak / 1e9:.3f} GB, "
                f"transient {(peak - resident) / 1e9:.3f} GB")
        t = time.perf_counter()
        refs = ahead.get("nested")
        n3_rows = ahead.get("n3_rows")
        n6, _, n6_s, _ = worker.get("n6")
        log(f"nested: references waited {time.perf_counter() - t:.1f} s "
            f"after the queries (N6's json in {n6_s:.1f} s in a second "
            "process)")
    finally:
        ahead.close()
    for name, (rows, again) in results.items():
        if name == "N6":
            want = n6
            for r in (rows, *again):
                got = {x["prio"]: (x["total"], x["p1"], x["notes"], x["n"])
                       for x in r}
                check(got.keys() == want.keys() and all(
                    nested_same(list(got[k]), list(want[k])) for k in want),
                    f"nested N6: {got} != json {want}")
        elif name == "N3_rows":
            check(all(r == n3_rows for r in (rows, *again)),
                  f"nested N3_rows: {rows[:2]} != {n3_rows[:2]}")
        elif name == "N1":
            for r in (rows, *again):
                got = {x["pos"]: (x["rev"], x["n"]) for x in r}
                check(nested_same(got, {k: v for k, v in
                                        refs["N1"].items()}),
                      f"nested N1: {got} != numpy {refs['N1']}")
        else:
            for r in (rows, *again):
                check(len(r) == 1 and nested_same(r[0], refs[name]),
                      f"nested {name}: {r} != numpy {refs[name]}")
        log(f"nested {name}: the first run and {len(again)} warm runs "
            f"match the {'json' if name == 'N6' else 'numpy'} reference")
    log("nested summary " + json.dumps({q: {
        k: r[k] for k in ("first_s", "warm_s", "elements_per_s", "peak_gb",
                          "transient_gb", "fold_steps")}
        | {"b1": r["launches"]["tile_reduce"],
           "b3": r["launches"]["tile_group_reduce"]}
        for q, r in report.items()}))
    return report, runs["N2"], refs["N2"], (on_batches, json_batches,
                                            refs["N4_explode"])


#: phase 5f (ANSI mode, the DataFrame surface, the rest of the
#: expression library): E3's range, E3's sample, E5's sketch, E6's uuid
#: rows and E7's hashed rows and JSON documents
SURFACE_RANGE = 1 << 28
SURFACE_SAMPLE = (0.01, 11)
SURFACE_PCTS = (0.25, 0.5, 0.9, 0.99)
#: ApproxPercentile's centroids at its default accuracy (10000 // 64)
SURFACE_SKETCH_K = 156
SURFACE_UUID_ROWS = 1 << 22
SURFACE_HASH_BATCHES = 4          # lineitem's first 4,194,304 rows
#: from_json / to_json run on the CPU engine (the planner tags them
#: there, as the JAX planner does): over N6's first batch of documents
SURFACE_JSON_BATCHES = 1
SURFACE_BLOOM_DAYS = (days(1995, 1, 1), days(1995, 4, 1))
SURFACE_JUNE_1995 = (days(1995, 6, 1), days(1995, 7, 1))


def numpy_murmur3_long(np, v, seed):
    """Spark's Murmur3 hashLong of int64 lanes: the low word, then the
    high, then fmix with length 8 (uint32 lanes)."""
    u = v.astype(np.uint64)
    h = np.full(len(v), np.uint32(seed), np.uint32)
    h = numpy_murmur3_step(np, (u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                           h)
    h = numpy_murmur3_step(np, (u >> np.uint64(32)).astype(np.uint32), h)
    return numpy_murmur3_fmix(np, h, 8)


def numpy_bytes_of(np, v):
    """BigInteger.toByteArray of int64 unscaled values, left-aligned in
    (n, 8) uint8 rows, and each row's length (1 to 8)."""
    mag = np.where(v < 0, ~v, v).astype(np.uint64)
    bits = np.zeros(len(v), np.int64)
    for s in range(63, -1, -1):
        bits = np.where((bits == 0) & ((mag >> np.uint64(s)) != 0), s + 1,
                        bits)
    n = bits // 8 + 1
    full = v.astype(">i8").view(np.uint8).reshape(-1, 8)   # big-endian
    at = (8 - n)[:, None] + np.arange(8)[None, :]
    out = np.where(at < 8, np.take_along_axis(full, np.minimum(at, 7), 1), 0)
    return out.astype(np.uint64), n


def numpy_murmur3_bytes(np, raw, n, seed):
    """Spark's Murmur3 hashUnsafeBytes of rows of at most 8 bytes:
    4-byte little-endian blocks, then the tail bytes sign-extended."""
    h = np.full(len(n), np.uint32(seed), np.uint32)
    for blk in range(2):
        word = sum((raw[:, 4 * blk + k] << np.uint64(8 * k))
                   for k in range(4)).astype(np.uint32)
        h = np.where(n >= 4 * (blk + 1), numpy_murmur3_step(np, word, h), h)
    tail = (n // 4) * 4
    for k in range(3):
        pos = np.minimum(tail + k, 7)
        byte = np.take_along_axis(raw, pos[:, None], 1)[:, 0].astype(np.int64)
        byte = np.where(byte >= 128, byte - 256, byte).astype(np.uint32)
        h = np.where(tail + k < n, numpy_murmur3_step(np, byte, h), h)
    return numpy_murmur3_fmix(np, h, n.astype(np.uint32))


def numpy_xxhash64_bytes(np, raw, n, seed):
    """Spark's XXH64 hashUnsafeBytes of rows of at most 8 bytes."""
    p1, p2 = np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F)
    p3, p4 = np.uint64(0x165667B19E3779F9), np.uint64(0x85EBCA77C2B2AE63)
    p5 = np.uint64(0x27D4EB2F165667C5)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))
    with np.errstate(over="ignore"):
        h = np.uint64(seed) + p5 + n.astype(np.uint64)
        word8 = sum(raw[:, k] << np.uint64(8 * k) for k in range(8))
        h = np.where(n >= 8, rotl(h ^ (rotl(word8 * p2, 31) * p1), 27) * p1
                     + p4, h)
        at = (n // 8) * 8
        rows = np.arange(len(n))
        word4 = sum(raw[rows, np.minimum(at + k, 7)] << np.uint64(8 * k)
                    for k in range(4))
        has4 = at + 4 <= n
        h = np.where(has4, rotl(h ^ (word4 * p1), 23) * p2 + p3, h)
        at = np.where(has4, at + 4, at)
        for k in range(3):
            byte = raw[rows, np.minimum(at + k, 7)]
            h = np.where(at + k < n, rotl(h ^ (byte * p5), 11) * p1, h)
        h = h ^ (h >> np.uint64(33))
        h = h * p2
        h = h ^ (h >> np.uint64(29))
        h = h * p3
        return (h ^ (h >> np.uint64(32))).view(np.int64)


def python_byte_hashes(v: int):
    """Plain-Python ports of Spark's Murmur3 and XXH64 hashUnsafeBytes of
    BigInteger.toByteArray(v) (seed 42): what the numpy lanes above are
    held against on their first rows."""
    m32, m64 = 0xFFFFFFFF, (1 << 64) - 1
    bits = v.bit_length() if v >= 0 else (~v).bit_length()
    b = v.to_bytes(bits // 8 + 1, "big", signed=True)

    def rotl(x, r, w):
        return ((x << r) | (x >> (w - r))) & ((1 << w) - 1)
    h = 42
    for i in range(0, len(b) - len(b) % 4, 4):
        k = (rotl((int.from_bytes(b[i:i + 4], "little") * 0xCC9E2D51) & m32,
                  15, 32) * 0x1B873593) & m32
        h = (rotl(h ^ k, 13, 32) * 5 + 0xE6546B64) & m32
    for i in range(len(b) - len(b) % 4, len(b)):
        k = (rotl(((b[i] - 256 if b[i] >= 128 else b[i]) & m32) * 0xCC9E2D51
                  & m32, 15, 32) * 0x1B873593) & m32
        h = (rotl(h ^ k, 13, 32) * 5 + 0xE6546B64) & m32
    h ^= len(b)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m32
    mm = h ^ (h >> 16)
    p1, p2, p3, p4, p5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                          0x27D4EB2F165667C5)
    x, at = (42 + p5 + len(b)) & m64, 0
    while at + 8 <= len(b):
        k = (rotl((int.from_bytes(b[at:at + 8], "little") * p2) & m64, 31,
                  64) * p1) & m64
        x = (rotl(x ^ k, 27, 64) * p1 + p4) & m64
        at += 8
    if at + 4 <= len(b):
        x = (rotl(x ^ (int.from_bytes(b[at:at + 4], "little") * p1 & m64),
                  23, 64) * p2 + p3) & m64
        at += 4
    for i in range(at, len(b)):
        x = (rotl(x ^ (b[i] * p5 & m64), 11, 64) * p1) & m64
    x ^= x >> 33
    x = (x * p2) & m64
    x ^= x >> 29
    x = (x * p3) & m64
    x ^= x >> 32
    return (mm - (1 << 32) if mm >= 1 << 31 else mm,
            x - (1 << 64) if x >= 1 << 63 else x)


def half_up_unscaled(np, x, scale):
    """The port's float -> DECIMAL(p, scale) unscaled values (x >= 0):
    HALF_UP on the value's shortest decimal (expr/cast.py)."""
    p = 10.0 ** scale
    q = np.floor(x * p)
    return (q + (x >= (q + 0.5) / p)).astype(np.int64)


def numpy_interleave2(np, a, b):
    """interleave_bits(a, b) of two BIGINT or INT lanes: the top 31 bits
    of each (in unsigned order: a BIGINT's sign bit flipped, 2^31 added
    to an INT), a's bit i at 2i, b's at 2i + 1; the bits spread by
    masks."""
    def top31(v):
        if v.dtype == np.int32:
            u = (v.astype(np.int64) + (1 << 31)).view(np.uint64)
            return (u >> np.uint64(1)) & np.uint64((1 << 31) - 1)
        u = v.view(np.uint64) ^ np.uint64(1 << 63)
        return (u >> np.uint64(33)) & np.uint64((1 << 31) - 1)

    def spread(x):
        for s, m in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                     (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                     (1, 0x5555555555555555)):
            x = (x | (x << np.uint64(s))) & np.uint64(m)
        return x
    return (spread(top31(a)) | (spread(top31(b)) << np.uint64(1))) \
        .view(np.int64)


def numpy_popcount64(np, v):
    """Set bits of int64 lanes (the SWAR popcount; uint64 wraps)."""
    x = v.view(np.uint64)
    with np.errstate(over="ignore"):
        x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
        x = (x & np.uint64(0x3333333333333333)) + \
            ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
        x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)) \
            .astype(np.int64)


def surface_references(np, li, od):
    """Phase 5f's numpy references over the TPC-H host lanes: E2's rows
    without ANSI, E3's sample and shorthands, E4's bitwise sums (int64
    sums wrap, as a BIGINT SUM without ANSI does), E5's rank windows,
    E7's union sum and its hashed rows."""
    import decimal
    pk, ok, price, disc = li["pkey"], li["okey"], li["price"], li["disc"]
    ship = li["ship"]
    # each flag is one byte: its code
    rf = li["rf"].chars[li["rf"].offsets[:-1]]
    ls = li["ls"].chars[li["ls"].offsets[:-1]]
    out = {}

    def wrap(v):
        return (int(v) + 2 ** 63) % 2 ** 64 - 2 ** 63
    with np.errstate(over="ignore"):
        # E2 without ANSI: wrapped, null or saturated rows
        d = np.trunc(disc * 100.0).astype(np.int64)
        nz = d != 0
        r = pk[nz] % d[nz]                     # both positive
        cents = half_up_unscaled(np, price, 2)
        keep = cents < 10 ** 7
        out["e2"] = {
            "sum_overflow": [{"v": wrap(int(pk.sum()) * 10 ** 12)}],
            "row_overflow": [{"v": int((pk * np.int64(10 ** 14)).sum())}],
            "divide_by_zero": [{"v": int(r.sum()), "n": int(nz.sum())}],
            "string_cast": [{"v": None, "n": 0}],
            "int_cast": [{"v": int(np.clip(np.trunc(price * 100000.0),
                                           -2 ** 31, 2 ** 31 - 1)
                                   .astype(np.int64).sum())}],
            "decimal_cast": [{"v": decimal.Decimal(int(cents[keep].sum()))
                              .scaleb(-2), "n": int(keep.sum())}],
            "guarded": [{"v": int(r.sum()), "n": int(nz.sum())}]}
        # E3: sample's keep mask and the shorthands by l_returnflag
        frac, seed = SURFACE_SAMPLE
        h = numpy_murmur3_long(np, np.arange(len(pk), dtype=np.int64), seed)
        kept = h < np.uint32(min(int(frac * (1 << 32)), (1 << 32) - 1))
        out["sample"] = [{"n": int(kept.sum()),
                          "s": int(ok[kept].sum())}]
        groups = {}
        for code in np.flatnonzero(np.bincount(rf)):
            m = rf == code
            p = price[m]
            groups[chr(code)] = {
                "count": int(m.sum()), "sum": float(p.sum()),
                "min": float(p.min()), "max": float(p.max()),
                "avg": float(p.sum() / m.sum())}
        out["shorthands"] = groups
        # E4
        neg = -pk
        out["bitwise"] = [{
            "and_": wrap((ok & pk).sum()), "or_": wrap((ok | pk).sum()),
            "xor_": wrap((ok ^ pk).sum()), "not_": wrap((~ok).sum()),
            "shl": wrap((ok << np.int64(3)).sum()),
            "shr": wrap((neg >> np.int64(5)).sum()),
            "shru": wrap((neg.view(np.uint64) >> np.uint64(5))
                         .view(np.int64).sum()),
            "pc": int(numpy_popcount64(np, ok ^ pk).sum()),
            "z": wrap(numpy_interleave2(np, pk, ok).sum())}]
    # E5: each group's rank window of p * N, 2N / K wide on each side
    windows, june = {}, {}
    lo_d, hi_d = SURFACE_JUNE_1995
    in_june = (ship >= lo_d) & (ship < hi_d)
    for a in np.flatnonzero(np.bincount(rf)):
        for b in np.flatnonzero(np.bincount(ls)):
            m = (rf == a) & (ls == b)
            key = (chr(a), chr(b))
            v = np.sort(price[m])
            n = len(v)
            bound = 2 * n / SURFACE_SKETCH_K
            windows[key] = [(float(v[max(int(np.floor(p * n - bound)) - 1,
                                         0)]),
                             float(v[min(int(np.ceil(p * n + bound)),
                                         n - 1)]), bound)
                            for p in SURFACE_PCTS]
            june[key] = float(np.percentile(price[m & in_june], 50))
    out["approx"], out["june"] = windows, june
    # E7: the UNION's exact sum at scale 4, and the hashed rows
    out["union"] = [{"v": decimal.Decimal(100 * (
        int(np.trunc(price * 100.0).astype(np.int64).sum())
        + int(np.trunc(disc * 100.0).astype(np.int64).sum()))).scaleb(-4),
        "n": 2 * len(price)}]
    hn = SURFACE_HASH_BATCHES * BATCH_ROWS
    u = half_up_unscaled(np, price[:hn], 4)
    raw, nb = numpy_bytes_of(np, u)
    mm = numpy_murmur3_bytes(np, raw, nb, 42).view(np.int32)
    xx = numpy_xxhash64_bytes(np, raw, nb, 42)
    for i in range(2000):
        check(python_byte_hashes(int(u[i])) == (int(mm[i]), int(xx[i])),
              f"numpy byte hash of {u[i]} differs from the Python port")
    out["hashes"] = (mm, xx)
    return out


def surface_run(torch, dev, name, run, read_counts, rows_in):
    """One phase 5f query: a first run with every B1 / B3 launch held
    against the plain version, then WARM_RUNS warm runs that must launch
    the same; logs the walls, rows/s and the transient peak. Returns
    (first run's result, [each warm run's result], its numbers)."""
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    DK.reset_counts()
    with holding_launches(torch, DK) as hold:
        t = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
    counts = read_counts()
    check_held(hold, counts, f"surface {name}")
    again, walls = [], []
    for _ in range(WARM_RUNS):
        DK.reset_counts()
        t = time.perf_counter()
        again.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        check(read_counts() == counts, f"surface {name}: the warm run "
              f"launched {read_counts()}, the first {counts}")
    wall = statistics.median(walls) if walls else first
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"first_s": first, "warm_s": wall if walls else None,
           "rows_per_s": rows_in / wall,
           "transient_gb": (peak - resident) / 1e9, "launches": counts,
           "held": dict(hold.held), "max_abs_err": dict(hold.err)}
    log(f"surface {name}: first {first:.4f} s (B1 / B3 held), "
        f"{warm_note(walls)}, {rows_in / wall:.4e} rows/s (the "
        f"{'warm median' if walls else 'first run'}); launches {counts}; "
        f"transient {(peak - resident) / 1e9:.3f} GB")
    return got, again, out


def surface_raises(torch, name, run, exc, first_line):
    """An ANSI query that must raise ``exc`` (by class name) whose message
    begins with ``first_line``; returns the seconds to the raise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        run()
    except Exception as e:  # the raised error is the result checked
        took = time.perf_counter() - t
        check(type(e).__name__ == exc and
              str(e).splitlines()[0] == first_line,
              f"surface {name}: raised {type(e).__name__}: {e}, expected "
              f"{exc}: {first_line}")
        log(f"surface {name}: raised {exc} ({first_line}) in {took:.4f} s")
        return took
    check(False, f"surface {name}: did not raise {exc}")


def surface_phase(torch, np, dev, session, batches, host, dec_session,
                  nested, worker, read_counts, tpch_refs, tpch_launches,
                  plan_guard):
    """Phase 5f over the resident SF10 tables: E1 TPC-H q1 / q6 under
    ANSI, E2 ANSI's errors at scale, E3 the DataFrame surface, E4
    bitwise, E5 percentiles, E6 bloom / uuid / misc, E7 Spark's
    widenings (decimal UNION, DECIMAL(p>18) hashes, map explode,
    from_json / to_json in SQL). Each held against numpy / Python
    (``surface_references`` from ``worker``, the rest here). Returns
    the report: per query its walls, launches and holds."""
    import decimal
    import json as pyjson

    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr import bitwise as B
    from spark_rapids_tpu_torch.expr import hashing as H
    from spark_rapids_tpu_torch.expr import misc as MX
    from spark_rapids_tpu_torch.expr.cast import Cast
    from spark_rapids_tpu_torch.expr.conditional import If
    from spark_rapids_tpu_torch.expr.core import Alias, col, lit
    from spark_rapids_tpu_torch.models import nested as NM
    from spark_rapids_tpu_torch.models import surface as SF
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import bloom as BL
    from spark_rapids_tpu_torch.plan.host_table import batch_to_table
    from spark_rapids_tpu_torch.plan.session import TpuSession
    t_phase = time.perf_counter()
    report = {}
    li_b = batches["lineitem"]
    ansi = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS,
                               "srt.sql.ansi.enabled": True}), device=dev)
    for s in (ansi, session):
        s.create_or_replace_temp_view("lineitem", s.from_batches(li_b))
    a_li, li = ansi.table("lineitem"), session.table("lineitem")
    ref6, ref1 = tpch_refs

    def same(got, want):
        if isinstance(want, dict):
            return isinstance(got, dict) and got.keys() == want.keys() and \
                all(same(got[k], want[k]) for k in want)
        if isinstance(want, (list, tuple)):
            return len(got) == len(want) and all(
                same(g, w) for g, w in zip(got, want))
        if isinstance(want, float):
            return isinstance(got, float) and abs(got - want) <= \
                RTOL * abs(want)
        return got == want

    def held(name, run, want, rows_in, must=(), equal=None):
        got, again, r = surface_run(torch, dev, name, run, read_counts,
                                    rows_in)
        for g in (got, *again):
            check(same(g, want), f"surface {name}: {g} != {want}")
        for k in must:
            check(r["launches"][k] > 0, f"surface {name}: {k} did not run")
        for k, n in (equal or {}).items():
            check(r["launches"][k] == n, f"surface {name}: {k} launched "
                  f"{r['launches'][k]} times, without ANSI {n}")
        report[name] = r
        return got

    # --- E1: q6 and q1 under ANSI, as without it -------------------------
    held("e1_q6_ansi", lambda: tpch.q6(a_li).collect(), ref6, ROWS,
         equal={"tile_reduce": tpch_launches["q6"]["tile_reduce"]})
    held("e1_q1_ansi", lambda: tpch.q1(a_li).collect(), ref1, ROWS,
         equal={"tile_group_reduce": tpch_launches["q1"]["tile_group_reduce"]})
    refs, _, refs_s, _ = worker.get("surface")
    log(f"surface: numpy references in {refs_s:.1f} s in a second process")

    # --- E2: ANSI's errors at scale; without ANSI, numpy's rows ----------
    for name, (text, exc, first_line) in SF.E2.items():
        took = surface_raises(torch, f"e2_{name}",
                              lambda: ansi.sql(text).collect(), exc,
                              first_line)
        held(f"e2_{name}", lambda: session.sql(text).collect(),
             refs["e2"][name], ROWS)
        report[f"e2_{name}"]["raise_s"] = took
    held("e2_guarded_ansi", lambda: ansi.sql(SF.E2_GUARDED).collect(),
         refs["e2"]["guarded"], ROWS)

    # --- E3: the DataFrame surface ------------------------------------------
    n = SURFACE_RANGE
    lo_x, hi_x = 1000, n // 2
    rng_q = session.range(0, n).select(
        Alias(Cast(col("id"), dt.FLOAT64), "x")).filter(
        (col("x") >= lit(float(lo_x))) & (col("x") < lit(float(hi_x)))).agg(
        Agg.Sum(col("x")).alias("s"), Agg.CountStar().alias("n"))
    held("e3_range", rng_q.collect,
         [{"s": float((hi_x - 1) * hi_x // 2 - (lo_x - 1) * lo_x // 2),
           "n": hi_x - lo_x}], n, equal={"tile_reduce": n // BATCH_ROWS})
    frac, seed = SURFACE_SAMPLE
    smp = li.sample(frac, seed=seed).agg(Agg.CountStar().alias("n"),
                                          Agg.Sum(col("l_orderkey"))
                                          .alias("s"))
    held("e3_sample", smp.collect, refs["sample"], ROWS)
    metrics_text = smp.explain(metrics=True)
    physical, _ = session._last_execution
    stack, ops = [physical], []
    while stack:
        node = stack.pop()
        ops.append(node.node_description())
        stack.extend(node.children)
    for op in ops:
        check(any(op in ln and "opTime=" in ln
                  for ln in metrics_text.splitlines()),
              f"surface explain(metrics=True) lacks {op}:\n{metrics_text}")
    log(f"surface e3_explain_metrics: names {len(ops)} operators, each with "
        "its opTime")
    g = li.group_by("l_returnflag")
    sh = refs["shorthands"]
    for how, make, key in (
            ("count", lambda: g.count(), "count"),
            ("sum", lambda: g.sum("l_extendedprice"), "sum"),
            ("min", lambda: g.min("l_extendedprice"), "min"),
            ("max", lambda: g.max("l_extendedprice"), "max"),
            ("avg", lambda: g.avg("l_extendedprice"), "avg")):
        out_col = "count" if how == "count" else f"{how}(l_extendedprice)"
        held(f"e3_grouped_{how}", lambda make=make, out_col=out_col: {
            r["l_returnflag"]: r[out_col] for r in make().collect()},
            {k: v[key] for k, v in sh.items()}, ROWS,
            must=() if how in ("min", "max") else ("tile_group_reduce",))
    okey, price = host["lineitem"]["okey"], host["lineitem"]["price"]
    small = host["lineitem"]["pkey"] < 3      # about 600 rows at SF10
    order = np.argsort(-price[small], kind="stable")
    want = {"l_orderkey": [int(v) for v in okey[small][order]],
            "l_extendedprice": [float(v) for v in price[small][order]]}
    tiny = li.filter(col("l_partkey") < lit(3))
    held("e3_count", tiny.count, int(small.sum()), ROWS)
    held("e3_sort_desc_to_pydict", lambda: tiny.select(
        "l_orderkey", "l_extendedprice").sort_desc("l_extendedprice")
        .to_pydict(), want, ROWS)

    # --- E4: bitwise over l_orderkey, l_partkey ---------------------------
    ok_c, pk_c = col("l_orderkey"), col("l_partkey")
    neg = -pk_c
    bits = li.agg(*[Alias(Agg.Sum(e), k) for k, e in (
        ("and_", B.BitwiseAnd(ok_c, pk_c)), ("or_", B.BitwiseOr(ok_c, pk_c)),
        ("xor_", B.BitwiseXor(ok_c, pk_c)), ("not_", B.BitwiseNot(ok_c)),
        ("shl", B.ShiftLeft(ok_c, lit(3))), ("shr", B.ShiftRight(neg, lit(5))),
        ("shru", B.ShiftRightUnsigned(neg, lit(5))),
        ("pc", B.BitCount(B.BitwiseXor(ok_c, pk_c))),
        ("z", B.InterleaveBits(pk_c, ok_c)))])
    held("e4_bitwise", bits.collect, refs["bitwise"], ROWS)

    # --- E5: percentiles --------------------------------------------------
    approx = li.group_by("l_returnflag", "l_linestatus").agg(
        Agg.ApproxPercentile(col("l_extendedprice"), list(SURFACE_PCTS))
        .alias("p"))
    got, again, r = surface_run(torch, dev, "e5_approx_percentile", lambda: {
        (x["l_returnflag"], x["l_linestatus"]): x["p"]
        for x in approx.collect()}, read_counts, ROWS)
    for g in (got, *again):
        check(g.keys() == refs["approx"].keys(), f"approx groups {g.keys()}")
        for key, ps in g.items():
            for p, v, (lo, hi, bound) in zip(SURFACE_PCTS, ps,
                                             refs["approx"][key]):
                check(lo <= v <= hi, f"approx_percentile {key} p={p}: {v} "
                      f"outside [{lo}, {hi}], the values within {bound:.0f} "
                      "ranks of p * N")
    report["e5_approx_percentile"] = r
    log(f"surface e5_approx_percentile: each answer's rank within 2N / K "
        f"(K = {SURFACE_SKETCH_K}) of p * N in its group's sorted prices")
    lo_d, hi_d = SURFACE_JUNE_1995
    june = li.filter((col("l_shipdate") >= lit(datetime.date(1995, 6, 1))) &
                     (col("l_shipdate") < lit(datetime.date(1995, 7, 1)))) \
        .group_by("l_returnflag", "l_linestatus").agg(
            Agg.Percentile(col("l_extendedprice"), 0.5).alias("p50"))
    plan_guard["allow"] = True
    try:
        marks = [ln for ln in june.explain("NOT_ON_TPU").splitlines()
                 if ln.lstrip().startswith("!")]
        check([ln.split("[")[0] for ln in marks] ==
              ["! Aggregate", "! CpuAggregate"],
              f"exact percentile: CPU-engine marks {marks}")
        held("e5_percentile_june_1995", lambda: {
            (x["l_returnflag"], x["l_linestatus"]): x["p50"]
            for x in june.collect()}, refs["june"], ROWS)
    finally:
        plan_guard["allow"] = False

    # --- E6: bloom filter, uuid, partition id, version, raise_error --------
    od = host["orders"]
    q1_95 = (od["odate"] >= SURFACE_BLOOM_DAYS[0]) & \
        (od["odate"] < SURFACE_BLOOM_DAYS[1])
    keys = od["okey"][q1_95]
    nbits = BL.choose_num_bits(len(keys))
    want_bits = np.zeros(nbits, bool)
    h1 = numpy_murmur3_long(np, keys, 0x9E3779B9).astype(np.int64)
    h2 = numpy_murmur3_long(np, keys, 0x85EBCA6B).astype(np.int64) | 1
    for i in range(BL.NUM_HASHES):
        want_bits[(h1 + i * h2) & (nbits - 1)] = True
    t = time.perf_counter()
    dev_bits = torch.zeros(nbits, dtype=torch.bool, device=dev)
    for b in batches["orders"]:
        d = b.column("o_orderdate").data
        live = b.live_mask() & (d >= SURFACE_BLOOM_DAYS[0]) & \
            (d < SURFACE_BLOOM_DAYS[1])
        dev_bits |= BL.build_bloom([b.column("o_orderkey")], live, nbits)
    torch.cuda.synchronize()
    check(np.array_equal(dev_bits.cpu().numpy(), want_bits),
          "bloom: the card's bits differ from numpy's double hash")
    log(f"surface e6_bloom_build: {len(keys)} keys of 1995's first quarter, "
        f"{nbits} bits built on the card in {time.perf_counter() - t:.3f} "
        "s, equal to numpy's")
    member = np.zeros(int(od["okey"].max()) + 2, bool)
    member[keys] = True
    in_set = member[np.minimum(okey, len(member) - 1)] & (okey < len(member))
    probe = li.select(Alias(H.BloomFilterMightContain(col("l_orderkey"),
                                                      dev_bits), "m"))

    def hits():
        return probe.to_table().columns[0].values
    got, again, r = surface_run(torch, dev, "e6_might_contain", hits,
                                read_counts, ROWS)
    for g in (got, *again):
        check(bool(np.all(g[in_set])), "might_contain: a false negative")
    fp = float(got[~in_set].mean())
    target = (1 - np.exp(-BL.NUM_HASHES * len(keys) / nbits)) ** \
        BL.NUM_HASHES
    check(fp <= 1.5 * target + 1e-4, f"might_contain: false-positive rate "
          f"{fp:.5f}, target {target:.5f}")
    r |= {"fp_rate": fp, "fp_target": target}
    report["e6_might_contain"] = r
    log(f"surface e6_might_contain: no false negative over "
        f"{int(in_set.sum())} member rows; false-positive rate {fp:.5f} "
        f"against {target:.5f} (choose_num_bits' {nbits} bits, "
        f"{BL.NUM_HASHES} hashes)")
    uq = session.range(0, SURFACE_UUID_ROWS).select(
        Alias(MX.uuid_expr(), "u"))

    def uuids():
        lane = uq.to_table().columns[0].values
        return lane.offsets, lane.chars
    (offs, chars), _, r = surface_run(torch, dev, "e6_uuid", uuids,
                                      read_counts, SURFACE_UUID_ROWS)
    nu = SURFACE_UUID_ROWS
    check(bool(np.all(np.diff(offs) == 36)), "uuid: a string not 36 long")
    text = chars[:nu * 36].reshape(nu, 36)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    digits = np.isin(text, hexd)
    dash = np.array([8, 13, 18, 23])
    check(bool(np.all(text[:, dash] == ord("-"))) and
          bool(np.all(np.delete(digits, dash, axis=1))) and
          bool(np.all(text[:, 14] == ord("4"))) and
          bool(np.all(np.isin(text[:, 19], np.frombuffer(b"89ab",
                                                         np.uint8)))),
          "uuid: not the v4 form")
    check(len(np.unique(text.view("S36"))) == nu, "uuid: repeated values")
    report["e6_uuid"] = r
    log(f"surface e6_uuid: {nu} distinct v4 strings")
    ctx_q = li.agg(Alias(Agg.Sum(MX.spark_partition_id()), "pid"),
                   Alias(Agg.Count(MX.version()), "nv"))
    held("e6_partition_id_version", ctx_q.collect,
         [{"pid": 0, "nv": ROWS}], ROWS)
    held("e6_version_rows", lambda: li.limit(2).select(
        Alias(MX.version(), "v")).collect(),
        [{"v": MX.version_string()}] * 2, 2)
    quiet = li.agg(Alias(Agg.Count(If(col("l_quantity") > lit(100.0),
                                      MX.raise_error("boom"), lit("ok"))),
                         "n"))
    held("e6_raise_error_unselected", quiet.collect, [{"n": ROWS}], ROWS)
    loud = li.agg(Alias(Agg.Count(If(col("l_quantity") > lit(49.0),
                                     MX.raise_error("boom"), lit("ok"))),
                        "n"))
    report["e6_raise_error_selected"] = {"raise_s": surface_raises(
        torch, "e6_raise_error_selected", loud.collect,
        "RaiseErrorException", "boom")}

    # --- E7: Spark's widenings ----------------------------------------------
    dl = dec_session.table("lineitem")
    u = dl.select(Alias(col("l_extendedprice"), "v")).union(dl.select(
        Alias(Cast(col("l_discount"), dt.DecimalType(15, 4)), "v")))
    check(u.schema == [("v", dt.DecimalType(15, 4))],
          f"decimal UNION type {u.schema}")
    held("e7_decimal_union", u.agg(Alias(Agg.Sum(col("v")), "v"),
                                   Alias(Agg.CountStar(), "n")).collect,
         refs["union"], 2 * ROWS)
    hb = session.from_batches(li_b[:SURFACE_HASH_BATCHES])
    w = Cast(col("l_extendedprice"), dt.DecimalType(24, 4))
    hq = hb.select(Alias(H.Murmur3Hash(w), "m"), Alias(H.XxHash64(w), "x"))

    def hashed():
        t = hq.to_table()
        return t.columns[0].values, t.columns[1].values
    (m_got, x_got), again, r = surface_run(
        torch, dev, "e7_decimal_hashes", hashed, read_counts,
        SURFACE_HASH_BATCHES * BATCH_ROWS)
    mm, xx = refs["hashes"]
    for m_, x_ in ((m_got, x_got), *again):
        check(np.array_equal(m_, mm) and np.array_equal(x_, xx),
              "DECIMAL(24,4) hash differs from Spark's byte hash")
    report["e7_decimal_hashes"] = r
    log(f"surface e7_decimal_hashes: murmur3 and xxhash64 of "
        f"{len(mm)} DECIMAL(24,4) rows equal Spark's byte hashes (numpy, "
        "its first 2000 rows held against the plain-Python port)")
    on_batches, json_batches, n4x_ref = nested
    on = session.from_batches(on_batches)
    held("e7_map_explode", lambda: NM.n4_explode(NM.port_api(), on)
         .collect(), [n4x_ref], sum(b.num_rows for b in on_batches))
    head = json_batches[:SURFACE_JSON_BATCHES]
    session.create_or_replace_temp_view("orders_json_head",
                                        session.from_batches(head))
    docs = [d for b in head
            for d in batch_to_table(b).columns[0].values.to_objects()]
    def json_row(doc):
        """Python's json: a document cut short (one in MALFORMED_EVERY)
        is a NULL struct, and its to_json NULL."""
        try:
            d = pyjson.loads(doc)
        except ValueError:
            return {"s": None, "j": None}
        return {"s": {"o_orderpriority": d["o_orderpriority"],
                      "o_totalprice": float(d["o_totalprice"])},
                "j": pyjson.dumps({"o_orderpriority": d["o_orderpriority"]},
                                  separators=(",", ":"))}
    want = [json_row(d) for d in docs]
    plan_guard["allow"] = True
    try:
        held("e7_json_sql", lambda: session.sql(
            "SELECT from_json(doc, 'o_orderpriority STRING, o_totalprice "
            "DOUBLE') AS s, to_json(from_json(doc, 'o_orderpriority "
            "STRING')) AS j FROM orders_json_head").collect(), want,
            len(docs))
    finally:
        plan_guard["allow"] = False
    report["seconds"] = time.perf_counter() - t_phase
    log(f"surface: phase 5f in {report['seconds']:.1f} s; summary " +
        json.dumps({q: {k: v[k] for k in ("first_s", "warm_s", "rows_per_s",
                                          "transient_gb") if k in v}
                    | ({"b1": v["launches"]["tile_reduce"],
                        "b3": v["launches"]["tile_group_reduce"]}
                       if "launches" in v else {})
                    for q, v in report.items() if isinstance(v, dict)}))
    return report


#: phase 5g: the TPC-H tables as Parquet files of tpch_tables' chunk
#: (262,144 rows: 229 lineitem files), written by a pool of writers;
#: G3's every-type table; G6's files
SCAN_FILE_ROWS = 1 << 18
SCAN_WRITERS = 8
SCAN_TYPES_ROWS = 1 << 22
SCAN_READERS = ("COALESCING", "MULTITHREADED")
#: the ten proleptic days before 1582-10-15 that the Julian calendar
#: skips: a LEGACY write and read does not bring them back (Spark's
#: rebase), so G3's LEGACY table leaves them out
JULIAN_GAP = (-141437, -141427)


def scan_root(np, prefix="srt_scan"):
    """A fresh directory for phase 5g's (or 5h's) files: under the
    temporary directory or the repo's output directory, whichever has
    more free space. Returns (path, its free bytes)."""
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    free = {}
    for base in (tempfile.gettempdir(), os.path.join(here, "chiprun_out")):
        os.makedirs(base, exist_ok=True)
        free[base] = shutil.disk_usage(base).free
    base = max(free, key=free.get)
    root = os.path.join(base, f"{prefix}_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root, free[base]


def tpch_file_tables(np, host):
    """The resident TPC-H tables' host lanes cut into files of
    SCAN_FILE_ROWS rows, in tpch_tables' layout: {table: [(file name,
    HostTable)]}, the tables views of the lanes (o_shippriority, the
    spec's one-choice 0, made here)."""
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    out = {}
    for spec in tpch.tpch_table_specs(ROWS):
        lanes = host[spec.name]
        by_col = {c: k for k, c in {**HOST_COLS[spec.name],
                                    **HOST_STRS[spec.name]}.items()}
        files = []
        for i, start in enumerate(range(0, spec.num_rows, SCAN_FILE_ROWS)):
            stop = min(start + SCAN_FILE_ROWS, spec.num_rows)
            cols = []
            for c in spec.columns:
                if c.name in by_col:
                    v = lanes[by_col[c.name]]
                    v = HostStrings(v.offsets[start:stop + 1], v.chars) \
                        if isinstance(v, HostStrings) else v[start:stop]
                else:
                    v = np.zeros(stop - start, c.dtype.np_physical)
                cols.append(HostColumn(v, np.ones(stop - start, bool),
                                       c.dtype))
            files.append((f"{spec.name}-{i:05d}.parquet",
                          HostTable(cols, [c.name for c in spec.columns])))
        out[spec.name] = files
    return out


def raw_bytes(table):
    """A host table's lane bytes as PLAIN pages hold them (a string's
    4-byte length included)."""
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    total = 0
    for c in table.columns:
        v = c.values
        if isinstance(v, HostStrings):
            total += int(v.offsets[-1] - v.offsets[0]) + 4 * len(v)
        elif v.dtype == object:
            total += 16 * len(v)
        else:
            total += v.nbytes
    return total


def write_files(jobs, options):
    """[(path, HostTable)] written by SCAN_WRITERS threads: (bytes, wall
    s, thread s summed)."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_tpu_torch.io.writer import write_file

    def one(job):
        t = time.perf_counter()
        n = write_file(job[1], job[0], options)
        return n, time.perf_counter() - t
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SCAN_WRITERS) as pool:
        done = list(pool.map(one, jobs))
    return (sum(n for n, _ in done), time.perf_counter() - t0,
            sum(s for _, s in done))


def scan_metrics(session):
    """The last query's scan numbers: its metric totals and the scan
    nodes' inclusive host time (opTime), in s."""
    physical, ctx = session._last_execution
    totals = ctx.metric_totals()
    op = sum(m["opTime"].value for k, m in ctx.metrics.items()
             if k.startswith("FileSourceScanExec"))
    return totals, op / 1e9


def types_table(np, n, seed=14):
    """G3's table: every flat type, about 10% NULL in each column; NaN,
    +-inf and -0.0 in the floats, empty and multi-byte strings, dates
    and timestamps before 1582 (outside JULIAN_GAP), DECIMAL(12,2) and
    DECIMAL(24,4) to their extremes."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.datagen import ColumnSpec, _choice_strings
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    rng = np.random.default_rng(seed)
    f64 = rng.standard_normal(n) * 1e6
    f64[rng.integers(0, n, n // 50)] = np.nan
    f64[:5] = [np.inf, -np.inf, -0.0, 0.0, 5e-324]
    f32 = (rng.standard_normal(n) * 1e3).astype(np.float32)
    f32[rng.integers(0, n, n // 50)] = np.nan
    f32[:4] = [np.inf, -np.inf, -0.0, 1e-45]
    words = ["", "a", "héllo", "日本語テキスト", "emoji \U0001F600", "x" * 200,
             "tab\tand\nnewline", "URGENT", "1-URGENT"]
    masks = [rng.random(n) >= 0.1 for _ in range(12)]
    # a NULL string's slot holds no bytes, as the decoder gives it back
    strs = _choice_strings(ColumnSpec("s", dt.STRING, "choice",
                                      choices=words),
                           np.where(masks[7], rng.integers(0, len(words), n),
                                    0))
    day = rng.integers(-250_000, 40_000, n)
    gap = (day >= JULIAN_GAP[0]) & (day < JULIAN_GAP[1])
    day = np.where(gap, JULIAN_GAP[1], day).astype(np.int32)
    us = day.astype(np.int64) * 86_400_000_000 + rng.integers(
        0, 86_400_000_000, n)
    wide = (rng.integers(-10 ** 12 + 1, 10 ** 12, n).astype(object)
            * 10 ** 12 + rng.integers(0, 10 ** 12, n).astype(object))
    wide[:2] = [10 ** 24 - 1, -(10 ** 24 - 1)]
    lanes = [("b", dt.BOOL, rng.random(n) < 0.5),
             ("i8", dt.INT8, rng.integers(-128, 128, n).astype(np.int8)),
             ("i16", dt.INT16,
              rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
             ("i32", dt.INT32,
              rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
             ("i64", dt.INT64, rng.integers(-2 ** 63, 2 ** 63 - 1, n)),
             ("f32", dt.FLOAT32, f32), ("f64", dt.FLOAT64, f64),
             ("s", dt.STRING, strs), ("d", dt.DATE, day),
             ("ts", dt.TIMESTAMP, us),
             ("m", dt.DecimalType(12, 2),
              rng.integers(-10 ** 12 + 1, 10 ** 12, n)),
             ("w", dt.DecimalType(24, 4), wide)]
    cols = []
    for (name, t, v), mask in zip(lanes, masks):
        if not isinstance(v, np.ndarray) or v.dtype == object:
            cols.append(HostColumn(v, mask, t))   # strings, wide decimals
        else:
            cols.append(HostColumn(np.where(mask, v, np.zeros(1, v.dtype)),
                                   mask, t))
    return HostTable(cols, [n for n, _, _ in lanes])


def same_bits(np, got, want, label):
    """Two host tables equal bit for bit where valid (floats by their
    bits, strings by their bytes), with equal null masks."""
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    check(got.names == want.names, f"{label}: columns {got.names}")
    for name, g, w in zip(want.names, got.columns, want.columns):
        check(g.dtype == w.dtype and np.array_equal(g.mask, w.mask),
              f"{label}: {name}'s type or nulls differ")
        live = np.nonzero(w.mask)[0]
        if isinstance(w.values, HostStrings):
            # both hold no bytes under a NULL: offsets and bytes compare
            # whole
            a, b = g.values, w.values
            ok = np.array_equal(a.offsets - a.offsets[0],
                                b.offsets - b.offsets[0]) and \
                np.array_equal(a.chars[a.offsets[0]:a.offsets[-1]],
                               b.chars[b.offsets[0]:b.offsets[-1]])
        elif w.dtype.is_floating:
            width = np.int32 if w.values.dtype == np.float32 else np.int64
            ok = np.array_equal(g.values[live].view(width),
                                w.values[live].view(width))
        else:
            ok = np.array_equal(g.values[live], w.values[live])
        check(ok, f"{label}: column {name} differs")


def build_host_lib():
    """The Parquet host library built (g++) and loaded: its seconds."""
    from spark_rapids_tpu_torch.io import host_lib as HL
    t = time.perf_counter()
    HL.lib()
    return time.perf_counter() - t


def types_worker(conn, root, n):
    """G3's host half in a process of its own: ``types_table(np, n)``
    written under each codec the build has (SCAN_FILE_ROWS-row files on
    SCAN_WRITERS threads) into ``root``/types/, read back by the host
    decode and held bit-equal to it; sends ("types", {codec: numbers})
    or ("error", traceback). It hides the card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        import shutil

        import numpy as np

        from spark_rapids_tpu_torch.io import host_lib as HL
        from spark_rapids_tpu_torch.io.native_parquet import (
            iter_row_group_tables_native)
        from spark_rapids_tpu_torch.plan.host_table import concat_tables
        t0 = time.perf_counter()
        types = types_table(np, n)
        out = {"build_s": time.perf_counter() - t0,
               "raw_bytes": raw_bytes(types)}
        for codec in ("none", "snappy", "gzip", "zstd"):
            if {"none": "UNCOMPRESSED"}.get(codec, codec.upper()) not in \
                    HL.codecs():
                continue
            d = os.path.join(root, "types", codec)
            os.makedirs(d)
            nbytes, wall, _ = write_files(
                [(os.path.join(d, f"part-{i:05d}.parquet"),
                  types.slice(a, a + SCAN_FILE_ROWS))
                 for i, a in enumerate(range(0, n, SCAN_FILE_ROWS))],
                {"compression": codec})
            t = time.perf_counter()
            back = concat_tables([x for f in sorted(os.listdir(d)) for x in
                                  iter_row_group_tables_native(
                                      os.path.join(d, f), types.schema(),
                                      {}, 1 << 30, None)])
            read_s = time.perf_counter() - t
            same_bits(np, back, types, f"scan G3 {codec}")
            out[codec] = {"bytes": nbytes, "write_s": wall, "read_s": read_s}
            shutil.rmtree(d)
        out["s"] = time.perf_counter() - t0
        conn.send(("types", out))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def scan_phase(torch, np, dev, host, dfs, queries, resident, read_counts,
               plan_guard, host_lib, scan_dir, types_w):
    """Phase 5g: the Parquet scan and writer on the card. G1 writes the
    resident TPC-H tables as tpch_tables' files; G2 runs ``queries``
    (name -> (query over tpch_tables' DataFrames, numpy rows, fact rows,
    {reader: (launches it must give, launches it must reach)})) through
    tpch_tables under each of SCAN_READERS: a first run with every B1 /
    B3 launch held and (but for the string aggregates) a warm run, each
    equal to numpy and to the resident tables' rows (``resident``); G3
    every flat type under each codec; G4 orders by priority and
    input_file_name(); G5 the CPU engine's FileScan; G6 a truncated and
    a deleted file. ``host_lib`` (a references_ahead) builds the host
    library since the smoke began. Returns the report: per query its
    walls, launches and scan numbers."""
    import shutil

    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr import misc as MX
    from spark_rapids_tpu_torch.expr.core import Alias, col
    from spark_rapids_tpu_torch.io import host_lib as HL
    from spark_rapids_tpu_torch.io.native_parquet import (
        iter_row_group_tables_native, read_metadata)
    from spark_rapids_tpu_torch.io.scan import FileSourceScanExec
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan import overrides
    from spark_rapids_tpu_torch.plan.session import TpuSession
    t_phase = time.perf_counter()
    report = {}
    li, od = host["lineitem"], host["orders"]

    def session(**conf):
        return TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS,
                                   "srt.sql.reader.batchSizeRows": BATCH_ROWS,
                                   **conf}), device=dev)

    # --- G1: write -----------------------------------------------------------
    t = time.perf_counter()
    build_s = host_lib.get("host_lib")
    host_lib.close()
    log(f"scan G1: host library {os.path.basename(HL.library_path())} "
        f"built with g++ in {build_s:.1f} s on a host thread since the "
        f"smoke began (waited {time.perf_counter() - t:.1f} s), codecs "
        f"{HL.codecs()}")
    root, free, types_raw = scan_dir
    files = tpch_file_tables(np, host)
    raw = sum(raw_bytes(t) for fs in files.values() for _, t in fs)
    log(f"scan G1: {root}: {free} bytes free when the smoke began; the "
        f"TPC-H files hold at most {raw} bytes and G3's {types_raw} at a "
        "time (their PLAIN pages, uncompressed)")
    check(free >= 2 * (raw + types_raw), f"scan G1: {free} bytes free in "
          f"{root}, under twice the {raw + types_raw} bytes the phase "
          "writes")
    jobs = []
    for name, fs in files.items():
        os.makedirs(os.path.join(root, "tpch", name))
        jobs += [(os.path.join(root, "tpch", name, f), t) for f, t in fs]
    nbytes, wall, thread_s = write_files(jobs, {"compression": "snappy"})
    report["G1_write"] = {"files": len(jobs), "bytes": nbytes,
                          "raw_bytes": raw, "s": wall, "thread_s": thread_s}
    log(f"scan G1: wrote {len(jobs)} files "
        f"({[len(f) for f in files.values()]} lineitem / orders / "
        f"customer) of {SCAN_FILE_ROWS} rows, snappy, {nbytes} bytes "
        f"({nbytes / raw:.3f} of their {raw} raw) in {wall:.2f} s on "
        f"{SCAN_WRITERS} threads ({thread_s:.2f} thread-s): "
        f"{nbytes / wall / 1e9:.3f} GB/s written, {raw / wall / 1e9:.3f} "
        f"GB/s of lanes encoded")
    del files, jobs

    # --- G2: q6, q1, q3 and the string aggregates from the files -------------
    for reader in SCAN_READERS:
        s = session(**{"srt.sql.format.parquet.reader.type": reader})
        tables = tpch.tpch_tables(s, os.path.join(root, "tpch"), ROWS)
        for name, (make, ref, rows_in, expect) in queries.items():
            if reader not in expect:
                continue
            label = f"scan {reader} {name}"
            walls = []
            # the string aggregates (B2's path) take a held first run
            runs = ("first",) if name.startswith("strings") else \
                ("first", "warm")
            for run in runs:
                DK.reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                if run == "first":
                    with holding_launches(torch, DK) as hold:
                        rows = make(tables).collect()
                    torch.cuda.synchronize()
                else:
                    rows = make(tables).collect()
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                counts = read_counts()
                if run == "first":
                    check_held(hold, counts, label)
                    first = counts
                check(same_rows(rows, ref), f"{label} ({run}): {rows} != "
                      f"numpy {ref}")
                check(same_rows(rows, resident[name]), f"{label} ({run}): "
                      f"{rows} != the resident tables' {resident[name]}")
                check(counts == first, f"{label}: the warm run launched "
                      f"{counts}, the first {first}")
                exact, at_least = expect[reader]
                for key, n in exact.items():
                    check(counts[key] == n, f"{label}: {key} launched "
                          f"{counts[key]} times, expected {n}")
                for key, n in at_least.items():
                    check(counts[key] >= n, f"{label}: {key} launched "
                          f"{counts[key]} times, expected at least {n}")
                totals, scan_s = scan_metrics(s)
            dec_s = totals.get("scanDecodeTime", 0) / 1e9
            dec_b = totals.get("scanDecodedBytes", 0)
            warm = walls[-1]
            report[f"{reader}_{name}"] = {
                "first_s": walls[0], "warm_s": warm, "launches": first,
                "max_abs_err": dict(hold.err), "rows_in": rows_in,
                "scan_s": scan_s, "scan_share": scan_s / warm,
                "upload_s": totals.get("scanTime", 0) / 1e9,
                "decode_thread_s": dec_s, "decoded_bytes": dec_b,
                "bytes_read": totals.get("scanBytesRead", 0),
                "files": totals.get("scanFiles", 0)}
            log(f"{label}: matches numpy and the resident tables; first "
                f"{walls[0]:.4f} s"
                + (f", warm {warm:.4f} s" if len(walls) > 1 else "")
                + f" ({rows_in / warm:.4e} rows/s, the last run's); launches "
                f"{first}; the scan {scan_s:.4f} s of the last run's wall "
                f"({scan_s / warm:.3f}): upload (scanTime) "
                f"{totals.get('scanTime', 0) / 1e9:.4f} s, decode "
                f"{dec_s:.4f} thread-s for {dec_b} bytes "
                f"({dec_b / max(dec_s, 1e-9) / 1e9:.3f} GB/s a thread, "
                f"{dec_b / max(scan_s, 1e-9) / 1e9:.3f} GB/s through the "
                f"scan), {totals.get('scanBytesRead', 0)} bytes read "
                f"from {totals.get('scanFiles', 0)} files (warm: the "
                "page cache's)")
        del tables, s
    shutil.rmtree(os.path.join(root, "tpch"))

    # --- G3: every flat type under each codec --------------------------------
    # the host half (SCAN_TYPES_ROWS rows under each codec, read back by
    # the host decode) runs in ``types_w`` since the smoke began; here a
    # batch of the same types through the card, and LEGACY dates
    from spark_rapids_tpu_torch.io.writer import write_host_table
    from spark_rapids_tpu_torch.plan.host_table import HostTable
    types = types_table(np, BATCH_ROWS)
    d = os.path.join(root, "types_card")
    os.makedirs(d)
    write_files([(os.path.join(d, f"part-{i:05d}.parquet"),
                  types.slice(a, a + SCAN_FILE_ROWS))
                 for i, a in enumerate(range(0, BATCH_ROWS, SCAN_FILE_ROWS))],
                {"compression": "snappy"})
    s = session()
    t = time.perf_counter()
    back = s.execute(s.read.parquet(d).plan)
    card_s = time.perf_counter() - t
    same_bits(np, back, types, "scan G3 (card)")
    log(f"scan G3: {BATCH_ROWS} rows x {len(types.names)} flat types "
        f"through the card (snappy) bit-equal, nulls included, {card_s:.2f} "
        "s")
    # dates and timestamps before 1582 under LEGACY: written and read back
    # on the hybrid Julian calendar, equal to the proleptic values
    dt_table = HostTable([types.column("d"), types.column("ts")], ["d", "ts"])
    d = os.path.join(root, "types_legacy")
    write_host_table(dt_table, d, options={"datetimeRebaseMode": "LEGACY"})
    old = int((types.column("d").values < JULIAN_GAP[1]).sum())
    for mode, same in (("LEGACY", True), ("CORRECTED", False)):
        s = session(**{"srt.sql.parquet.datetimeRebaseModeInRead": mode})
        back = s.execute(s.read.parquet(d).plan)
        equal = all(np.array_equal(b.values[b.mask], w.values[w.mask])
                    for b, w in zip(back.columns, dt_table.columns))
        check(equal == same, f"scan G3: a LEGACY write read {mode} "
              f"{'differs from' if same else 'equals'} the dates")
    log(f"scan G3: dates and timestamps ({old} dates before 1582) written "
        "LEGACY read back LEGACY equal through the card, CORRECTED not")
    del types, dt_table, back

    # --- G4: orders by priority, and input_file_name() -----------------------
    d = os.path.join(root, "orders_by_priority")
    t = time.perf_counter()
    st = dfs["orders"].write.partition_by("o_orderpriority").parquet(d)
    write_s = time.perf_counter() - t
    check(st.num_files == 5 and st.num_rows == ROWS // 4,
          f"scan G4: wrote {st}")
    log(f"scan G4: orders written by o_orderpriority: {st.num_files} files, "
        f"{st.num_rows} rows, {st.num_bytes} bytes in {write_s:.2f} s "
        f"({st.partitions})")
    urgent = host_match(np, od["prio"], b"1-URGENT")
    want = [{"total": float(od["total"][urgent].sum()),
             "n": int(urgent.sum())}]

    def urgent_query(s):
        return (s.read.parquet(d)
                .filter(col("o_orderpriority") == "1-URGENT")
                .agg(Alias(Agg.Sum(col("o_totalprice")), "total"),
                     Alias(Agg.CountStar(), "n")))
    s = session()
    DK.reset_counts()
    t = time.perf_counter()
    with holding_launches(torch, DK) as hold:
        device_rows = urgent_query(s).collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    check_held(hold, counts, "scan G4 urgent")
    totals, _ = scan_metrics(s)
    check(totals.get("partitionsPruned") == 4,
          f"scan G4: {totals.get('partitionsPruned')} partitions pruned")
    check(same_rows(device_rows, want), f"scan G4: {device_rows} != numpy "
          f"{want}")
    report["G4_urgent"] = {"s": wall, "launches": counts,
                           "max_abs_err": dict(hold.err)}
    log(f"scan G4: o_orderpriority = '1-URGENT' read 1 of 5 files "
        f"(partitionsPruned 4), {device_rows} equal numpy, {wall:.4f} s, "
        f"launches {counts}")
    files_df = s.read.parquet(d).select(Alias(MX.input_file_name(), "f")) \
        .group_by("f").agg(Alias(Agg.CountStar(), "n"))
    physical = overrides.apply_overrides(files_df.plan, s.conf)

    def scans(node):
        return ([node] if isinstance(node, FileSourceScanExec) else []) + \
            [x for c in node.children for x in scans(c)]
    check([x.reader_type(s.conf) for x in scans(physical)] == ["PERFILE"],
          "scan G4: input_file_name() did not force the per-file reader")
    DK.reset_counts()
    with holding_launches(torch, DK) as hold:
        per_file = {r["f"]: r["n"] for r in files_df.collect()}
    counts = read_counts()
    check_held(hold, counts, "scan G4 input_file_name")
    footers = {p: read_metadata(p).num_rows for p in per_file}
    check(per_file == footers and len(per_file) == 5,
          f"scan G4: rows per file {per_file} != the footers' {footers}")
    report["G4_input_file_name"] = {"launches": counts,
                                    "max_abs_err": dict(hold.err)}
    log(f"scan G4: input_file_name() under PERFILE: rows per file equal "
        f"each footer's num_rows ({sorted(footers.values())}); launches "
        f"{counts}")

    # --- G5: the CPU engine's FileScan over the same files -------------------
    plan_guard["allow"] = True
    t = time.perf_counter()
    cpu_rows = urgent_query(session(**{"srt.sql.enabled": False})).collect()
    plan_guard["allow"] = False
    check(same_rows(cpu_rows, device_rows), f"scan G5: the CPU engine's "
          f"{cpu_rows} != the card's {device_rows}")
    log(f"scan G5: the CPU engine's FileScan (srt.sql.enabled=false) gives "
        f"G4's rows in {time.perf_counter() - t:.2f} s")
    shutil.rmtree(d)

    # --- G6: a truncated and a deleted lineitem file -------------------------
    qty = li["qty"]
    per = SCAN_FILE_ROWS
    for fault in ("corrupt", "missing"):
        d = os.path.join(root, "faults", fault)
        os.makedirs(d)
        write_files([(os.path.join(d, name), t) for name, t in
                     tpch_file_tables(np, host)["lineitem"][:4]],
                    {"compression": "snappy"})
        bad = os.path.join(d, "lineitem-00001.parquet")
        key = "srt.sql.ignoreCorruptFiles" if fault == "corrupt" else \
            "srt.sql.ignoreMissingFiles"

        def count_query(s):
            return s.read.parquet(d).agg(
                Alias(Agg.CountStar(), "n"),
                Alias(Agg.Sum(col("l_quantity")), "qty"))
        strict, lenient = count_query(session()), \
            count_query(session(**{key: True}))
        if fault == "corrupt":
            data = open(bad, "rb").read()
            with open(bad, "wb") as f:
                f.write(data[:len(data) // 2])
        else:
            os.remove(bad)
        try:
            strict.collect()
            raised = None
        except (ValueError, EOFError, OSError) as e:
            raised = e
        check(raised is not None and bad in str(raised),
              f"scan G6 {fault}: the default did not raise naming {bad}: "
              f"{raised!r}")
        kept = np.concatenate([qty[i * per:(i + 1) * per] for i in (0, 2, 3)])
        want = [{"n": len(kept), "qty": float(kept.sum())}]
        DK.reset_counts()
        with holding_launches(torch, DK) as hold:
            got = lenient.collect()
        counts = read_counts()
        check_held(hold, counts, f"scan G6 {fault}")
        check(same_rows(got, want), f"scan G6 {fault}: {key} gave {got}, "
              f"numpy over the other files {want}")
        report[f"G6_{fault}"] = {"launches": counts,
                                 "max_abs_err": dict(hold.err)}
        log(f"scan G6 {fault}: raises by default ({type(raised).__name__}, "
            f"naming the file); under {key} skipped, {got} equal numpy over "
            "the three files left")
    t = time.perf_counter()
    g3 = types_w.get("types")
    types_w.close()
    for codec in ("none", "snappy", "gzip", "zstd"):
        if codec in g3:
            r = g3[codec]
            report[f"G3_{codec}"] = r
            log(f"scan G3 {codec}: {SCAN_TYPES_ROWS} rows x 12 flat types "
                f"written ({r['bytes']} bytes, {r['write_s']:.2f} s) and read "
                f"back by the host decode ({r['read_s']:.2f} s) bit-equal, "
                "nulls included")
    log(f"scan G3: the {SCAN_TYPES_ROWS}-row table ({g3['raw_bytes']} raw "
        f"bytes, built in {g3['build_s']:.1f} s) under each codec in "
        f"{g3['s']:.1f} s in its own process (waited "
        f"{time.perf_counter() - t:.1f} s)")
    shutil.rmtree(root)
    # the scan's cached blocks back to the card before the later phases
    gc.collect()
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"scan phase 5g: {report['phase_s']:.1f} s; host RSS "
        f"{host_rss_gb():.2f} GB, the card's reserved "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.2f} GB")
    return report


# --- phase 5h: Delta Lake tables and the mortgage ETL ------------------------

#: H1's target rows and source rows (bench.py's config 4 shapes)
DELTA_ROWS = 1 << 23
#: rows each of H3's two racing appends writes
DELTA_RACE_ROWS = 1 << 20
#: H4's stream (bench.py's exactly-once lane): micro-batches, rows each
INGEST_BATCHES = 16
INGEST_ROWS = 1 << 18
#: the crash child's plan: the third durable commit's fsync (CREATE and
#: the epoch are the first two) kills it with 137
INGEST_CRASH = "seed=13|delta.commit.fsync:crash@3"
#: H6's loans; the performance table holds 12 a loan
MORTGAGE_LOANS = 1 << 20


def delta_bytes():
    """An upper bound of the PLAIN bytes phase 5h writes: H1 twice (the
    base, the MERGE's and the UPDATE's rewrites, 20 bytes a row), H3's
    DELETE, OPTIMIZE and racing appends, H4's three streams, H5's two
    commits and H6's two tables."""
    n = DELTA_ROWS
    h1 = 2 * 20 * (n + 3 * n // 2 + 3 * n // 2)
    h3 = 20 * (2 * n + 2 * DELTA_RACE_ROWS)
    h4 = 16 * 3 * INGEST_BATCHES * INGEST_ROWS
    h5 = 16 * 2 * n
    h6 = 24 * 12 * MORTGAGE_LOANS + 40 * MORTGAGE_LOANS
    return h1 + h3 + h4 + h5 + h6


class timed_calls:
    """Seconds spent inside the calls of each (owner, attribute, label)
    during the block: the wrappers replace the attributes and are taken
    out after it."""

    def __init__(self, targets):
        self.targets = targets
        self.s = {label: 0.0 for _, _, label in targets}

    def __enter__(self):
        self.saved = []
        for owner, attr, label in self.targets:
            own = attr in vars(owner)
            orig = vars(owner)[attr] if own else getattr(owner, attr)
            self.saved.append((owner, attr, own, orig))

            def wrapped(*a, _orig=orig, _label=label, **k):
                t = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    self.s[_label] += time.perf_counter() - t
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, own, orig in reversed(self.saved):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        return False


def delta_table(np, n, seed):
    """H1's target and source host tables (bench.py's shapes): the
    target k = 0..n-1, amount uniform in [0, 1e4), flag 0; the source k
    = n/2..3n/2-1, amount uniform, flag 1."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    rng = np.random.default_rng(seed)
    ok = np.ones(n, bool)

    def table(k, flag):
        return HostTable([HostColumn(k, ok, dt.INT64),
                          HostColumn(rng.uniform(0, 1e4, n), ok, dt.FLOAT64),
                          HostColumn(np.full(n, flag, np.int32), ok,
                                     dt.INT32)], ["k", "amount", "flag"])
    return (table(np.arange(n, dtype=np.int64), 0),
            table(np.arange(n // 2, n + n // 2, dtype=np.int64), 1))


def delta_want(np, base, src):
    """numpy's H1 versions over the dense key range 0..3n/2-1: {version:
    (present, {column: values})}, version 0 empty."""
    n = base.num_rows
    size = n + n // 2
    amount = np.concatenate([base.column("amount").values[:n // 2],
                             src.column("amount").values])
    flag = np.concatenate([np.zeros(n // 2, np.int32),
                           np.ones(n, np.int32)])
    present = np.zeros(size, bool)
    present[:n] = True
    v1 = {"amount": np.concatenate([base.column("amount").values,
                                    np.zeros(n // 2)]),
          "flag": np.zeros(size, np.int32)}
    v3 = {"amount": amount,
          "flag": flag + 2 * (amount > 5e3).astype(np.int32)}
    return {0: (np.zeros(size, bool), v1), 1: (present, v1),
            2: (np.ones(size, bool), {"amount": amount, "flag": flag}),
            3: (np.ones(size, bool), v3)}


def same_by_key(np, table, want, label, key="k"):
    """The host table's rows are numpy's ``want`` = (present, {column:
    values}) over a dense key range: each present key once and no
    other, and each column's value at its key (floats bit for bit: rows
    only copied); no NULL anywhere."""
    present, cols = want
    k = table.column(key).values
    check(len(k) == int(present.sum()), f"{label}: {len(k)} rows, numpy "
          f"{int(present.sum())}")
    check(all(bool(c.mask.all()) for c in table.columns),
          f"{label}: a NULL where numpy has none")
    check(len(k) == 0 or (k.min() >= 0 and k.max() < len(present)),
          f"{label}: a key outside numpy's")
    counts = np.bincount(k, minlength=len(present))
    check(np.array_equal(counts, present.astype(np.int64)),
          f"{label}: the keys differ from numpy's (each present key once)")
    for name, values in cols.items():
        got = np.empty(len(present), values.dtype)
        got[k] = table.column(name).values
        a, b = got[present], values[present]
        if a.dtype.kind == "f":
            a, b = a.view(np.int64), b.view(np.int64)
        check(np.array_equal(a, b), f"{label}: column {name} differs from "
              "numpy")


def stream_same(np, table, num_batches, rows, label):
    """H4's table holds the demo stream exactly once: ids 0..N-1 each
    once, v = id * 0.5, sum(v) as ``demo_expected`` (the sum is exact:
    every partial sum is a multiple of 0.5 below 2^53)."""
    from spark_rapids_tpu_torch.delta.streaming import demo_expected
    exp = demo_expected(num_batches, rows)
    ids = table.column("id").values
    v = table.column("v").values
    check(len(ids) == exp["rows"], f"{label}: {len(ids)} rows, expected "
          f"{exp['rows']}")
    check(np.array_equal(np.bincount(ids, minlength=exp["rows"]),
                         np.ones(exp["rows"], np.int64)),
          f"{label}: ids not each of 0..{exp['rows'] - 1} once")
    check(np.array_equal(v, ids * 0.5), f"{label}: v != id * 0.5")
    check(float(v.sum()) == exp["sum_v"], f"{label}: sum(v) {v.sum()} != "
          f"{exp['sum_v']}")


def mortgage_ahead(np, session, out_dir):
    """H6's tables (``mortgage_tables``: 262,144-row files through the
    port's writer) and numpy's features per loan over the same chunks
    regenerated (``generate_chunk``): (tables, reference, seconds to
    write, seconds for the reference)."""
    from spark_rapids_tpu_torch.columnar.vector import HostStrings
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.models import mortgage as M
    t = time.perf_counter()
    tables = M.mortgage_tables(session, out_dir, MORTGAGE_LOANS)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    acq_spec = M.acquisitions_spec(MORTGAGE_LOANS)
    perf_spec = M.performance_spec(MORTGAGE_LOANS)
    chunk = 1 << 18

    def lanes(spec, names):
        parts = [generate_chunk(spec, c, chunk)
                 for c in range(-(-spec.num_rows // chunk))]
        return {n: [p.column(n).values for p in parts] for n in names}
    perf = {k: np.concatenate(v) for k, v in lanes(
        perf_spec, ("loan_id", "days_delinquent", "current_upb")).items()}
    acq = lanes(acq_spec, ("loan_id", "orig_rate", "orig_amount",
                           "credit_score", "state"))
    loan = perf["loan_id"]
    dd = perf["days_delinquent"]
    cnt = np.bincount(loan, minlength=MORTGAGE_LOANS)
    has = cnt > 0
    order = np.argsort(loan, kind="stable")
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])[has]
    max_d = np.maximum.reduceat(dd[order], starts)
    d90 = np.bincount(loan, weights=(dd >= 90),
                      minlength=MORTGAGE_LOANS).astype(np.int64)
    upb = np.bincount(loan, weights=perf["current_upb"],
                      minlength=MORTGAGE_LOANS)
    # acquisitions are loan_id 0..n-1 in order (a seq column)
    state = HostStrings.concat(acq["state"])
    offsets, chars = state.offsets[:-1].astype(np.int64), state.chars
    check(bool(np.all(np.diff(state.offsets) == 2)),
          "the mortgage states are two bytes")
    ref = {
        "loan_id": np.nonzero(has)[0].astype(np.int64),
        "n_reports": cnt[has].astype(np.int64),
        "n_delinq_90": d90[has],
        "max_delinq": max_d.astype(np.int32),
        "avg_upb": upb[has] / cnt[has],
        "orig_rate": np.concatenate(acq["orig_rate"])[has],
        "orig_amount": np.concatenate(acq["orig_amount"])[has],
        "credit_score": np.concatenate(acq["credit_score"])[has],
        "state": ((chars[offsets].astype(np.int32) << 8)
                  | chars[offsets + 1])[has],
        "ever_90": (d90[has] > 0).astype(np.int32),
    }
    ca = (chars[offsets] == ord("C")) & (chars[offsets + 1] == ord("A"))
    amounts = np.concatenate(acq["orig_amount"])
    ref["ca"] = (float(amounts[ca].sum()), int(ca.sum()))
    return tables, ref, write_s, time.perf_counter() - t


def mortgage_same(torch, np, arrs, ref):
    """``to_device_arrays``' columns, ordered by loan on the card, equal
    numpy's features: the counts, maxima, flags and the acquisition
    columns exactly (floats bit for bit), avg_upb within RTOL."""
    n = arrs.num_rows
    check(n == len(ref["loan_id"]), f"mortgage: {n} loans, numpy "
          f"{len(ref['loan_id'])}")
    order = torch.argsort(arrs["loan_id"][0][:n])
    for name, want in ref.items():
        if name == "ca":
            continue
        data, valid = arrs[name]
        check(bool(valid[:n].all()), f"mortgage {name}: a NULL")
        if name == "state":
            offsets, chars = data
            o = offsets[:n][order].to(torch.int64)
            check(bool(((offsets[1:n + 1] - offsets[:n]) == 2).all()),
                  "mortgage state: not two bytes")
            got = ((chars[o].to(torch.int32) << 8) | chars[o + 1]).cpu() \
                .numpy()
        else:
            got = data[:n][order].cpu().numpy()
        check(got.dtype == want.dtype or name == "state",
              f"mortgage {name}: {got.dtype}, numpy {want.dtype}")
        if name == "avg_upb":
            ok = np.allclose(got, want, rtol=RTOL, atol=0.0)
        elif got.dtype.kind == "f":
            ok = np.array_equal(got.view(np.int64), want.view(np.int64))
        else:
            ok = np.array_equal(got, want)
        check(ok, f"mortgage {name}: differs from numpy")


def start_crash_child(root, device):
    """H4's crash child: the ingester of delta/streaming.py on
    ``device`` with ``INGEST_CRASH`` armed, started with subprocess
    (this process holds a CUDA context and must not fork); its output
    goes to a file under ``root``. Returns (Popen, table path, log
    path)."""
    table = os.path.join(root, "crash")
    out = os.path.join(root, "crash_child.log")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_tpu_torch.delta.streaming",
             table, "chaos", str(INGEST_BATCHES), str(INGEST_ROWS),
             "--fault-plan", INGEST_CRASH, "--create",
             "--checkpoint-interval", "8", "--device", device],
            cwd=here, stdout=f, stderr=subprocess.STDOUT)
    return proc, table, out


def delta_phase(torch, np, dev, read_counts):
    """Phase 5h: BASELINE configs 4 and 5 on the card. H1 the config 4
    upsert (CREATE, append, MERGE, UPDATE over DELTA_ROWS target and
    source rows), first on table A with every version held against
    numpy, then again on table B for warm walls; H2 B1 and B3 over B's
    scanned batches; H3 DELETE, OPTIMIZE ZORDER, VACUUM, two racing
    appends and a duplicate-key MERGE on A; H4 the exactly-once stream
    durable and relaxed, a crash child (started at the phase's start)
    and its resume; H5 the standard format; H6 the mortgage ETL to
    device arrays (its tables and numpy reference on a host thread since
    the phase began) and a B1 / B2 query over its acquisitions. Every B1
    / B3 launch of a first run held against its plain version. Returns
    the report (per held query its launches)."""
    import contextlib
    import shutil
    import threading

    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.delta import AcidTable, CommitConflict
    from spark_rapids_tpu_torch.delta import streaming as ST
    from spark_rapids_tpu_torch.delta.table import _StagedWrite
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr.core import Alias, col, lit
    from spark_rapids_tpu_torch.models import mortgage as M
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.session import TpuSession
    t_phase = time.perf_counter()
    report = {}
    n = DELTA_ROWS

    def session(**conf):
        return TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS,
                                   "srt.sql.reader.batchSizeRows": BATCH_ROWS,
                                   **conf}), device=dev)

    root, free = scan_root(np, "srt_delta")
    need = delta_bytes()
    check(free >= 2 * need, f"delta: {free} bytes free in {root}, under "
          f"twice the {need} bytes the phase writes")
    probe = os.path.join(root, "probe")
    with open(probe, "w") as f:
        f.write("x")
    os.link(probe, probe + ".link")      # the commit's O_EXCL arbiter
    check(os.path.samefile(probe, probe + ".link"), "delta: os.link")
    os.unlink(probe)
    os.unlink(probe + ".link")
    log(f"delta: {root}: {free} bytes free, the phase writes at most {need}"
        " (PLAIN); os.link works there")
    child, child_table, child_log = start_crash_child(root, dev.type)
    s = session()
    ahead = references_ahead([("mortgage", lambda: mortgage_ahead(
        np, s, os.path.join(root, "mortgage")))])
    try:
        base, src = delta_table(np, n, seed=15)
        want = delta_want(np, base, src)
        schema = base.schema()

        # --- H1: the config 4 upsert, first on A (held), then on B ----------
        def upsert(label, path, held):
            t = AcidTable.create(s, path, schema)
            base_df, src_df = s.create_dataframe(base), \
                s.create_dataframe(src)
            torch.cuda.synchronize()
            steps = {}
            DK.reset_counts()
            hold = holding_launches(torch, DK) if held else None
            for name, run, rows_in in (
                    ("append", lambda: t.append(base_df), n),
                    ("merge", lambda: t.merge(src_df, on=["k"],
                                              when_matched_update={
                                                  "amount": col("src_amount"),
                                                  "flag": col("src_flag")}),
                     2 * n),
                    ("update", lambda: t.update(
                        {"flag": col("flag") + lit(2)},
                        col("amount") > lit(5e3)), n + n // 2)):
                resident = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                if hold is not None:
                    hold.__enter__()
                try:
                    with executions_of(s, read_counts) as runs, timed_calls([
                            (s, "execute", "execute_s"),
                            (t, "_write_files", "encode_s"),
                            (_StagedWrite, "promote", "promote_s"),
                            (t.log, "commit", "commit_s")]) as tc:
                        t0 = time.perf_counter()
                        version = run()
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                finally:
                    if hold is not None:
                        hold.__exit__(None, None, None)
                adds = [a["add"] for a in t.log.read_actions(version)
                        if "add" in a]
                steps[name] = {
                    "s": wall, **tc.s, "version": version,
                    "rows_in": rows_in, "rows_per_s": rows_in / wall,
                    "files": len(adds),
                    "written_bytes": sum(os.path.getsize(
                        os.path.join(path, a["path"])) for a in adds),
                    "read_bytes": sum(c.metric_totals().get(
                        "scanBytesRead", 0) for _, c, _ in runs),
                    "transient_gb": (torch.cuda.max_memory_allocated(dev)
                                     - resident) / 1e9}
                st = steps[name]
                log(f"delta H1 {label} {name}: version {version} in "
                    f"{wall:.3f} s (execute {st['execute_s']:.3f}, encode "
                    f"{st['encode_s']:.3f}, promote {st['promote_s']:.3f}, "
                    f"log commit {st['commit_s']:.3f}); {rows_in} rows in, "
                    f"{st['rows_per_s']:.4e} rows/s; {len(adds)} files, "
                    f"{st['written_bytes'] / 1e9:.3f} GB written, "
                    f"{st['read_bytes'] / 1e9:.3f} GB read; transient peak "
                    f"{st['transient_gb']:.3f} GB")
            counts = read_counts()
            if hold is not None:
                check_held(hold, counts, f"delta H1 {label}")
                steps["max_abs_err"] = dict(hold.err)
            upsert_s = steps["merge"]["s"] + steps["update"]["s"]
            steps["merge_update_s"] = upsert_s
            steps["merge_update_rows_per_s"] = 2 * n / upsert_s
            steps["launches" if held else "warm_launches"] = counts
            log(f"delta H1 {label}: MERGE + UPDATE {upsert_s:.3f} s, "
                f"target + source {2 * n / upsert_s:.4e} rows/s (bench.py's "
                "delta_merge_rows_s)")
            return t, steps

        ta, report["H1_first"] = upsert("A (first)", os.path.join(root, "a"),
                                        True)
        for v in range(ta.version() + 1):
            same_by_key(np, ta.to_df(version=v).to_table(), want[v],
                        f"delta H1 version {v}")
        ops = [h["operation"] for h in ta.history()]
        check(ops == ["CREATE TABLE", "WRITE (append)", "MERGE", "UPDATE"],
              f"delta H1 history {ops}")
        log(f"delta H1: versions 0-3 equal numpy (to_df(version=1) the "
            f"base, floats bit for bit); history {ops}")
        tb, report["H1_warm"] = upsert("B (warm)", os.path.join(root, "b"),
                                       False)
        check(tb.version() == 3, "delta H1 B: four versions")

        # --- H2: B1 and B3 on B's scanned batches ---------------------------
        present3, cols3 = want[3]
        amount3, flag3 = cols3["amount"], cols3["flag"]
        # the COALESCING scan's batches of BATCH_ROWS rows
        n_batches = -(-len(amount3) // BATCH_ROWS)
        where = amount3[flag3 == 3]
        queries = {
            "H2_where": (lambda: tb.to_df().filter(col("flag") == 3).agg(
                Alias(Agg.Sum(col("amount")), "s"),
                Alias(Agg.CountStar(), "n")),
                [{"s": float(where.sum()), "n": len(where)}],
                {"tile_reduce": n_batches, "tile_reduce_str": 0}),
            "H2_group": (lambda: tb.to_df().group_by("flag").agg(
                Alias(Agg.Sum(col("amount")), "s"),
                Alias(Agg.CountStar(), "n")).sort("flag"),
                [{"flag": f, "s": float(amount3[flag3 == f].sum()),
                  "n": int((flag3 == f).sum())} for f in range(4)],
                {"tile_group_reduce": n_batches})}
        for name, (make, ref, expect) in queries.items():
            report[name] = held_run(torch, s, read_counts, name, make, ref,
                                    expect, len(amount3))

        # --- H5: the standard Delta format, from B --------------------------
        std = os.path.join(root, "standard")
        t0 = time.perf_counter()
        v0 = tb.to_df().write.partition_by("flag").delta(std)
        w0 = time.perf_counter() - t0
        check(v0 == 0, f"delta H5: first commit {v0}")
        t0 = time.perf_counter()
        same_by_key(np, s.read.delta(std).to_table(), want[3],
                    "delta H5 head")
        r0 = time.perf_counter() - t0
        t0 = time.perf_counter()
        v1 = tb.to_df().filter(col("flag") == 3).write.mode("overwrite") \
            .partition_by("flag").delta(std)
        w1 = time.perf_counter() - t0
        check(v1 == 1, f"delta H5: overwrite commit {v1}")
        same_by_key(np, s.read.delta(std).to_table(),
                    (present3 & (flag3 == 3), cols3), "delta H5 overwrite")
        same_by_key(np, s.read.delta(std, version_as_of=0).to_table(),
                    want[3], "delta H5 version_as_of=0")
        parts = sorted(d for d in os.listdir(std) if d.startswith("flag="))
        report["H5"] = {"write_s": w0, "read_s": r0, "overwrite_s": w1,
                        "partitions": parts}
        log(f"delta H5: standard format partitioned by flag ({parts}): "
            f"{len(present3)} rows written in {w0:.3f} s, read back in "
            f"{r0:.3f} s equal numpy; the overwrite ({int((flag3 == 3).sum())}"
            f" rows) in {w1:.3f} s; read.delta at the head and at "
            "version_as_of=0 equal numpy")

        # --- H3: the rest of the DML, on A ---------------------------------
        h3 = {}
        t0 = time.perf_counter()
        ta.delete(col("flag") == 1)
        h3["delete_s"] = time.perf_counter() - t0
        kept = present3 & (flag3 != 1)
        same_by_key(np, ta.to_df().to_table(), (kept, cols3),
                    "delta H3 delete")
        t0 = time.perf_counter()
        ta.optimize(zorder_by=["k", "flag"])
        h3["optimize_s"] = time.perf_counter() - t0
        opt = ta.to_df().to_table()
        same_by_key(np, opt, (kept, cols3), "delta H3 optimize")
        z = numpy_interleave2(np, opt.column("k").values,
                              opt.column("flag").values)
        check(bool(np.all(z[1:] >= z[:-1])), "delta H3: OPTIMIZE's rows are "
              "not in the numpy interleave's order")
        live = set(ta.log.snapshot()[1])
        added = {a["add"]["path"] for v in ta.log.versions()
                 for a in ta.log.read_actions(v) if "add" in a}
        t0 = time.perf_counter()
        removed = ta.vacuum()
        h3["vacuum_s"] = time.perf_counter() - t0
        check(set(removed) == added - live, f"delta H3: VACUUM removed "
              f"{len(removed)} files, the tombstoned are {len(added - live)}")
        check(sorted(f for f in os.listdir(ta.path)
                     if f.endswith(".parquet")) == sorted(live),
              "delta H3: VACUUM left a file the head does not name")
        # two appends at once: each commit waits for the other's, so one
        # loses the O_EXCL race and lands through the retry
        barrier = threading.Barrier(2, timeout=300)
        conflicts, done, errors = [], {}, []
        race_rows = DELTA_RACE_ROWS
        lo = n + n // 2
        race = [delta_race_table(np, lo + i * race_rows, race_rows, 16 + i)
                for i in range(2)]

        def racer(i):
            try:
                t = AcidTable.for_path(s, ta.path)
                commit, first = t.log.commit, [True]

                def commit_at_once(read_v, actions, op):
                    if first[0]:
                        first[0] = False
                        barrier.wait()
                    try:
                        return commit(read_v, actions, op)
                    except CommitConflict:
                        conflicts.append(i)
                        raise
                t.log.commit = commit_at_once
                done[i] = t.append(s.create_dataframe(race[i]))
            except Exception as e:  # noqa: BLE001  (raised below)
                errors.append(e)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        h3["race_s"] = time.perf_counter() - t0
        check(not errors, f"delta H3 race: {errors}")
        check(conflicts and sorted(done.values()) ==
              [ta.version() - 1, ta.version()], f"delta H3 race: versions "
              f"{done}, conflicts {conflicts}")
        check(ta.log.versions() == list(range(ta.version() + 1)),
              "delta H3 race: versions not contiguous")
        size = lo + 2 * race_rows
        grown = np.zeros(size, bool)
        grown[:lo] = kept
        grown[lo:] = True
        race_cols = {c: np.concatenate([cols3[c]] + [
            r.column(c).values for r in race]) for c in ("amount", "flag")}
        same_by_key(np, ta.to_df().to_table(), (grown, race_cols),
                    "delta H3 race")
        dup = s.create_dataframe(delta_race_table(np, 0, 2, 18).take(
            np.array([0, 0])))
        try:
            ta.merge(dup, on=["k"], when_matched_update={
                "amount": col("src_amount")})
            raise RuntimeError("chip_smoke: delta H3: a MERGE with a "
                               "duplicate source key did not raise")
        except ValueError as e:
            check("multiple source rows" in str(e), f"delta H3 dup: {e}")
        report["H3"] = {**h3, "tombstoned": len(removed),
                        "conflicts": len(conflicts)}
        log(f"delta H3: DELETE {h3['delete_s']:.3f} s, OPTIMIZE ZORDER BY "
            f"(k, flag) {h3['optimize_s']:.3f} s (rows equal numpy, in the "
            f"numpy interleave's order), VACUUM {h3['vacuum_s']:.3f} s removed"
            f" exactly the {len(removed)} tombstoned files; two {race_rows}-"
            f"row appends at once landed as versions {sorted(done.values())}"
            f" through {len(conflicts)} OCC conflict(s) in {h3['race_s']:.3f}"
            " s; a duplicate-key MERGE raised")

        # --- H4: exactly-once ingest, durable and relaxed; crash, resume -----
        h4 = {}
        total = INGEST_BATCHES * INGEST_ROWS
        for durable in (True, False):
            si = session(**{"srt.delta.durableCommits": durable,
                            "srt.delta.checkpointInterval": 8})
            path = os.path.join(root, f"ingest_{durable}")
            tab = AcidTable.create(si, path, ST.demo_schema())
            t0 = time.perf_counter()
            stats = ST.DeltaIngestor(tab, "bench").ingest(
                lambda b: si.create_dataframe(ST.demo_batch_table(
                    b, INGEST_ROWS)), INGEST_BATCHES)
            wall = time.perf_counter() - t0
            check(stats == {"committed": INGEST_BATCHES, "skipped": 0},
                  f"delta H4: {stats}")
            stream_same(np, tab.to_df().to_table(), INGEST_BATCHES,
                        INGEST_ROWS, f"delta H4 durable={durable}")
            h4["durable_s" if durable else "relaxed_s"] = wall
        h4["rows_per_s"] = total / h4["durable_s"]
        h4["relaxed_rows_per_s"] = total / h4["relaxed_s"]
        h4["commit_ms"] = h4["durable_s"] / INGEST_BATCHES * 1e3
        h4["fsync_overhead_pct"] = (h4["durable_s"] / h4["relaxed_s"] - 1) \
            * 100
        t0 = time.perf_counter()
        rc = child.wait(timeout=240)
        with open(child_log) as f:
            child_out = f.read()
        check(rc == 137, f"delta H4: the crash child exited {rc}, not 137:"
              f"\n{child_out[-2000:]}")
        sr = session(**{"srt.delta.checkpointInterval": 8})
        tab = AcidTable.for_path(sr, child_table)
        stats = ST.DeltaIngestor(tab, "chaos").ingest(
            lambda b: sr.create_dataframe(ST.demo_batch_table(
                b, INGEST_ROWS)), INGEST_BATCHES)
        h4["resume_s"] = time.perf_counter() - t0
        check(stats["committed"] + stats["skipped"] == INGEST_BATCHES,
              f"delta H4 resume: {stats}")
        stream_same(np, tab.to_df().to_table(), INGEST_BATCHES,
                    INGEST_ROWS, "delta H4 resume")
        tab.vacuum(retention_sec=0.0)
        on_disk = {f for f in os.listdir(child_table)
                   if f.endswith(".parquet")}
        check(on_disk == set(tab.log.snapshot()[1]),
              "delta H4: an unreferenced file after VACUUM")
        check(not [f for d in (child_table, tab.log.log_dir)
                   for f in os.listdir(d) if f.endswith(".tmp")],
              "delta H4: a .tmp file after VACUUM")
        h4["resumed"] = stats
        report["H4"] = h4
        log(f"delta H4: {INGEST_BATCHES} x {INGEST_ROWS} rows exactly once:"
            f" durable {h4['durable_s']:.3f} s ({h4['rows_per_s']:.4e} rows/s,"
            f" {h4['commit_ms']:.2f} ms a commit), relaxed "
            f"{h4['relaxed_s']:.3f} s ({h4['relaxed_rows_per_s']:.4e} rows/s)"
            f": fsync overhead {h4['fsync_overhead_pct']:.1f}%; the crash "
            f"child ({INGEST_CRASH}) exited 137, the resume {stats} in "
            f"{h4['resume_s']:.3f} s (waited for the child included): rows, "
            "ids and sum(v) as demo_expected, no .tmp and no unreferenced "
            "file after VACUUM")

        # --- H6: config 5, the mortgage ETL to device arrays ------------------
        t0 = time.perf_counter()
        tables, ref, write_s, ref_s = ahead.get("mortgage")
        log(f"delta H6: {MORTGAGE_LOANS} loans' tables written in "
            f"{write_s:.1f} s and numpy's features in {ref_s:.1f} s on a "
            f"host thread since the phase began (waited "
            f"{time.perf_counter() - t0:.1f} s)")
        perf_rows = 12 * MORTGAGE_LOANS
        h6 = {}
        for run in ("first", "warm"):
            resident = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            DK.reset_counts()
            torch.cuda.synchronize()
            with (holding_launches(torch, DK) if run == "first"
                  else contextlib.nullcontext()) as hold:
                t0 = time.perf_counter()
                arrs = M.mortgage_etl(tables["acquisitions"],
                                      tables["performance"]) \
                    .to_device_arrays()
                torch.cuda.synchronize()
                h6[f"{run}_s"] = time.perf_counter() - t0
            h6[f"{run}_transient_gb"] = (torch.cuda.max_memory_allocated(dev)
                                         - resident) / 1e9
            if run == "first":
                h6["launches"] = read_counts()
                check_held(hold, h6["launches"], "delta H6")
                h6["max_abs_err"] = dict(hold.err)
                mortgage_same(torch, np, arrs, ref)
            del arrs
        h6["rows_per_s"] = perf_rows / h6["warm_s"]
        report["H6"] = h6
        log(f"delta H6: mortgage_etl(...).to_device_arrays() over "
            f"{perf_rows} performance rows: first {h6['first_s']:.3f} s, "
            f"warm {h6['warm_s']:.3f} s ({h6['rows_per_s']:.4e} rows/s), "
            f"transient peak {h6['warm_transient_gb']:.3f} GB; "
            f"{len(ref['loan_id'])} loans' features equal numpy on the card "
            f"(avg_upb within {RTOL}); launches {h6['launches']}")
        ca_sum, ca_n = ref["ca"]
        report["H6_ca"] = held_run(
            torch, s, read_counts, "H6_ca",
            lambda: tables["acquisitions"].filter(col("state") == "CA").agg(
                Alias(Agg.Sum(col("orig_amount")), "s"),
                Alias(Agg.CountStar(), "n")),
            [{"s": ca_sum, "n": ca_n}], {}, MORTGAGE_LOANS)
        c = report["H6_ca"]["launches"]
        check(c["tile_reduce"] >= 1 and c["tile_reduce_str"] ==
              c["tile_reduce"], f"delta H6_ca: B1 with its string lane, "
              f"launched {c}")
    finally:
        ahead.close()
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(root, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"delta phase 5h: {report['phase_s']:.1f} s; host RSS "
        f"{host_rss_gb():.2f} GB, the card's reserved "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB")
    return report


def delta_race_table(np, lo, rows, seed):
    """Rows of H1's schema with k = lo..lo+rows-1, flag 5."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.plan.host_table import HostColumn, HostTable
    rng = np.random.default_rng(seed)
    ok = np.ones(rows, bool)
    return HostTable([HostColumn(np.arange(lo, lo + rows, dtype=np.int64),
                                 ok, dt.INT64),
                      HostColumn(rng.uniform(0, 1e4, rows), ok, dt.FLOAT64),
                      HostColumn(np.full(rows, 5, np.int32), ok, dt.INT32)],
                     ["k", "amount", "flag"])


def held_run(torch, session, read_counts, name, make, ref, expect, rows_in):
    """A query's first run with every B1 / B3 launch held (the counts
    set to 0 just before, read just after; ``expect`` maps counters to
    the counts it must give) and a warm run, each equal to ``ref``
    (same_rows). Returns its walls and launches."""
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    DK.reset_counts()
    torch.cuda.synchronize()
    with holding_launches(torch, DK) as hold:
        t0 = time.perf_counter()
        rows = make().collect()
        first = time.perf_counter() - t0
    counts = read_counts()
    check_held(hold, counts, f"delta {name}")
    check(same_rows(rows, ref), f"delta {name}: {rows} != numpy {ref}")
    for key, want in expect.items():
        check(counts[key] == want, f"delta {name}: {key} launched "
              f"{counts[key]} times, expected {want}")
    t0 = time.perf_counter()
    rows = make().collect()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(same_rows(rows, ref), f"delta {name}: the warm run disagrees")
    log(f"delta {name}: matches numpy over {rows_in} rows; launches "
        f"{counts}; first {first:.3f} s, warm {warm:.3f} s "
        f"({rows_in / warm:.4e} rows/s)")
    return {"first_s": first, "warm_s": warm, "launches": counts,
            "max_abs_err": dict(hold.err)}


def host_rss_gb():
    """This process's resident host memory, GB (/proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1e6
    return float("nan")


def li_str(lineitem):
    """The string-filtered global aggregate over lineitem (B1 with its
    string lane B2)."""
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr.core import Alias, col, lit
    from spark_rapids_tpu_torch.expr.predicates import InSet
    return (lineitem
            .filter(InSet(col("l_returnflag"), ["A", "R"])
                    & (col("l_linestatus") == "F")
                    & (col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                    & (col("l_shipdate") < lit(datetime.date(1995, 1, 1))))
            .agg(Alias(Agg.Sum(col("l_extendedprice") * col("l_discount")),
                       "revenue"),
                 Alias(Agg.CountStar(), "n")))


def ord_str(orders):
    """The string-filtered global aggregate over orders (B2)."""
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr.core import Alias, col, lit
    from spark_rapids_tpu_torch.expr.predicates import IsNotNull
    from spark_rapids_tpu_torch.expr.strings import StartsWith
    return (orders
            .filter((StartsWith(col("o_orderpriority"), "1-")
                     | (col("o_orderpriority") == "2-HIGH"))
                    & IsNotNull(col("o_orderpriority"))
                    & (col("o_orderdate") < lit(datetime.date(1995, 3, 15))))
            .agg(Alias(Agg.Sum(col("o_totalprice")), "total"),
                 Alias(Agg.CountStar(), "n")))


def scan_queries(refs, n_li, n_od):
    """Phase 5g's G2 queries: name -> (query over tpch_tables'
    DataFrames, numpy rows, fact rows, {reader: (launches it must give,
    launches it must reach)}); under COALESCING the resident tables'
    batch counts ``n_li`` / ``n_od``, under MULTITHREADED one a file."""
    from spark_rapids_tpu_torch.models import tpch
    ref6, ref1, ref_li, ref_od, ref3 = refs
    li_files = -(-ROWS // SCAN_FILE_ROWS)
    return {
        "q6": (lambda t: tpch.q6(t["lineitem"]), ref6, ROWS, {
            "COALESCING": ({"tile_reduce": n_li, "tile_reduce_str": 0}, {}),
            "MULTITHREADED": ({"tile_reduce": li_files,
                               "tile_reduce_str": 0}, {})}),
        "q1": (lambda t: tpch.q1(t["lineitem"]), ref1, ROWS, {
            "COALESCING": ({"tile_group_reduce": n_li}, {}),
            "MULTITHREADED": ({"tile_group_reduce": li_files}, {})}),
        "q3": (lambda t: tpch.q3(t["customer"], t["orders"], t["lineitem"]),
               ref3, ROWS, {r: ({"tile_reduce": 0}, {"tile_group_reduce": 1})
                            for r in SCAN_READERS}),
        "strings_lineitem": (lambda t: li_str(t["lineitem"]), ref_li, ROWS, {
            "COALESCING": ({"tile_reduce_str": n_li}, {})}),
        "strings_orders": (lambda t: ord_str(t["orders"]), ref_od, ROWS // 4,
                           {"COALESCING": ({"tile_reduce_str": n_od}, {})}),
    }


def tpch_references(np, li, od, cu):
    """numpy over the TPC-H host lanes: (q6, q1, the lineitem and orders
    string aggregates, q3's top 10, the lineitem rows q3 joins)."""
    def numpy_q6():
        m = ((li["ship"] >= days(1994, 1, 1)) & (li["ship"] < days(1995, 1, 1))
             & (li["disc"] >= 0.05) & (li["disc"] <= 0.07)
             & (li["qty"] < 24.0))
        return [{"revenue": float(np.sum(li["price"][m] * li["disc"][m]))}]

    def numpy_q1():
        m = li["ship"] <= days(1998, 9, 2)
        rf = li["rf"].chars[li["rf"].offsets[:-1]]
        ls = li["ls"].chars[li["ls"].offsets[:-1]]
        code = rf[m].astype(np.int64) * 256 + ls[m]
        keys, g = np.unique(code, return_inverse=True)
        price, disc = li["price"][m], li["disc"][m]
        qty, tax = li["qty"][m], li["tax"][m]
        disc_price = price * (1.0 - disc)

        def s(w):
            return np.bincount(g, weights=w, minlength=len(keys))
        cnt = np.bincount(g, minlength=len(keys))
        sums = {"sum_qty": s(qty), "sum_base_price": s(price),
                "sum_disc_price": s(disc_price),
                "sum_charge": s(disc_price * (1.0 + tax))}
        rows = []
        for i, k in enumerate(keys):
            r = {"l_returnflag": chr(k // 256), "l_linestatus": chr(k % 256)}
            r.update({n: float(v[i]) for n, v in sums.items()})
            r["avg_qty"] = float(s(qty)[i] / cnt[i])
            r["avg_price"] = float(s(price)[i] / cnt[i])
            r["avg_disc"] = float(s(disc)[i] / cnt[i])
            r["count_order"] = int(cnt[i])
            rows.append(r)
        return rows

    def numpy_li_str():
        m = ((host_match(np, li["rf"], b"A") | host_match(np, li["rf"], b"R"))
             & host_match(np, li["ls"], b"F")
             & (li["ship"] >= days(1994, 1, 1))
             & (li["ship"] < days(1995, 1, 1)))
        return [{"revenue": float(np.sum(li["price"][m] * li["disc"][m])),
                 "n": int(m.sum())}]

    def numpy_ord_str():
        m = ((host_match(np, od["prio"], b"1-", prefix=True)
              | host_match(np, od["prio"], b"2-HIGH"))
             & (od["odate"] < days(1995, 3, 15)))
        return [{"total": float(np.sum(od["total"][m])), "n": int(m.sum())}]

    def numpy_q3():
        cutoff = days(1995, 3, 15)
        ckeys = np.sort(cu["ckey"][host_match(np, cu["seg"], b"BUILDING")])
        om = od["odate"] < cutoff
        okey, ockey, odate = od["okey"][om], od["ckey"][om], od["odate"][om]
        at = np.minimum(np.searchsorted(ckeys, ockey), max(len(ckeys) - 1, 0))
        hit = ckeys[at] == ockey          # c_custkey is unique
        okey, odate = okey[hit], odate[hit]
        order = np.argsort(okey, kind="stable")
        okey, odate = okey[order], odate[order]
        lm = li["ship"] > cutoff
        lkey = li["okey"][lm]
        rev = li["price"][lm] * (1.0 - li["disc"][lm])
        at = np.minimum(np.searchsorted(okey, lkey), max(len(okey) - 1, 0))
        hit = okey[at] == lkey            # o_orderkey is unique
        groups, g = np.unique(lkey[hit], return_inverse=True)
        sums = np.bincount(g, weights=rev[hit], minlength=len(groups))
        gdate = odate[np.searchsorted(okey, groups)]
        top = np.argsort(-sums, kind="stable")[:10]
        epoch = datetime.date(1970, 1, 1)
        return [{"o_orderkey": int(groups[i]),
                 "o_orderdate": epoch + datetime.timedelta(days=int(gdate[i])),
                 "revenue": float(sums[i])} for i in top], int(hit.sum())

    return (numpy_q6(), numpy_q1(), numpy_li_str(), numpy_ord_str(),
            *numpy_q3())


#: the TPC-H host lanes main keeps beside the batches on the card:
#: {table: {key: column}} of numeric lanes, then of strings
HOST_COLS = {
    "lineitem": {"qty": "l_quantity", "price": "l_extendedprice",
                 "disc": "l_discount", "tax": "l_tax", "ship": "l_shipdate",
                 "okey": "l_orderkey", "pkey": "l_partkey"},
    "orders": {"okey": "o_orderkey", "ckey": "o_custkey",
               "total": "o_totalprice", "odate": "o_orderdate"},
    "customer": {"ckey": "c_custkey"}}
HOST_STRS = {"lineitem": {"rf": "l_returnflag", "ls": "l_linestatus"},
             "orders": {"prio": "o_orderpriority"},
             "customer": {"seg": "c_mktsegment"}}


def tpch_host_lanes(np, on_chunk=None):
    """lineitem (ROWS), orders and customer generated chunk by chunk:
    {table: {key: lane}} after HOST_COLS and HOST_STRS; each chunk also
    goes to ``on_chunk(table, chunk)``."""
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.models import tpch
    host = {}
    for spec in tpch.tpch_table_specs(ROWS):
        name = spec.name
        cols = {**HOST_COLS[name], **HOST_STRS[name]}
        lanes = {k: [] for k in cols}
        for c in range(-(-spec.num_rows // BATCH_ROWS)):
            chunk = generate_chunk(spec, c, BATCH_ROWS)
            for key, cname in cols.items():
                lanes[key].append(chunk.column(cname).values)
            if on_chunk is not None:
                on_chunk(name, chunk)
        host[name] = {k: (np.concatenate(v) if k in HOST_COLS[name]
                          else type(v[0]).concat(v))
                      for k, v in lanes.items()}
    return host


def host_worker(conn, jobs, zone, n_docs):
    """A second process's work: the TPC-H host lanes generated from the
    seeds main uses, then ``jobs`` in order, each sent as (job, (result,
    the lanes' seconds, the job's seconds, seconds since the process
    began)): "tpch" (``tpch_references``), "scalar"
    (``scalar_references``), "decimal" (``decimal_references``: D4's
    Python-int arrays hold the interpreter lock for seconds at a time,
    so a host thread of the smoke's would stall its launches),
    "surface", "fallback", "orders_json" (``orders_json``'s first
    ``n_docs`` documents as a host table, and the number of orders) and
    "n6" (N6's json reference over them). It hides the card, and sends
    ("error", traceback) if it fails."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        import numpy as np

        from spark_rapids_tpu_torch.models import nested as NM
        t0 = time.perf_counter()
        host = tpch_host_lanes(np)
        lanes_s = time.perf_counter() - t0
        li, od, cu = host["lineitem"], host["orders"], host["customer"]
        for job in jobs:
            t = time.perf_counter()
            if job == "tpch":
                out = tpch_references(np, li, od, cu)
            elif job == "scalar":
                out = scalar_references(np, li, od, cu, zone)
            elif job == "decimal":
                out = decimal_references(np, li, od, cu)
            elif job == "fallback":
                out = fallback_references(np, li, od)
            elif job == "surface":
                out = surface_references(np, li, od)
            elif job == "orders_json":
                li_t, od_t = nested_host_tables(np, host)
                no = NM.NestedOrders(li_t)
                docs = NM.json_docs(no, od_t, min(n_docs, no.n))
                out = NM.json_table(docs), no.n
                del li_t, od_t, no
            else:
                out = NM.json_reference(docs)
            conn.send((job, (out, lanes_s, time.perf_counter() - t,
                             time.perf_counter() - t0)))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def main():
    # the allocator setting the port asks for where queries spill under
    # a memory cap (README; a budget on the card warns without it): the
    # caching allocator grows segments in place instead of carving fixed
    # ones, so a capped run keeps less of its cap reserved but
    # unallocated; it must precede CUDA's first use, and memory phase
    # (b) checks that it holds
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.exec import pallas_agg
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr import hashing as H
    from spark_rapids_tpu_torch.expr.core import Alias, col, lit
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.plan import session as session_module
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    from spark_rapids_tpu_torch.plan.session import TpuSession
    from spark_rapids_tpu_torch.plan.transitions import (CpuPhysical,
                                                         HostToDeviceExec)

    # every query outside phase 5e (and phase 5f's exact percentile and
    # from_json / to_json, which the planner sends to the CPU engine)
    # must plan wholly on the device: no CPU-engine node, no seam (the
    # planner as the sessions call it)
    plan_guard = {"allow": False, "plans": 0}
    planner = session_module.apply_overrides

    def on_host(node):
        return isinstance(node, (CpuPhysical, HostToDeviceExec)) or any(
            on_host(c) for c in getattr(node, "children", []))

    def guarded_planner(plan, conf):
        physical = planner(plan, conf)
        if not plan_guard["allow"]:
            check(not on_host(physical), "a device-only query planned a "
                  f"CPU-engine node:\n{physical.tree_string()}")
            plan_guard["plans"] += 1
        return physical
    session_module.apply_overrides = guarded_planner

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    # on a line of its own, as nvidia-smi gives it
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # two more processes, each on its own host core: the TPC-H and
    # scalar references, and orders_json's documents with N6's
    # reference, ahead of the phases that read them
    zone, zone_why = scalar_zone()
    refs_worker = HostWorker(("tpch", "scalar", "decimal", "surface",
                              "fallback"),
                             zone, NESTED_JSON_ROWS)
    json_worker = HostWorker(("orders_json", "n6"), zone, NESTED_JSON_ROWS)
    # phase 5g's host library, built with g++ on a host thread meanwhile,
    # and its G3 host half in a process of its own
    host_lib = references_ahead([("host_lib", build_host_lib)])
    scan_dir = (*scan_root(np), int(1.3 * SCAN_TYPES_ROWS * 97))
    types_w = HostWorker(scan_dir[0], SCAN_TYPES_ROWS, target=types_worker)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- build, on a host thread while the data is made ----------------------
    def build():
        t0 = time.perf_counter()
        DK.build_group_kernel()
        lines = [f"build: nvcc tile_group_reduce {time.perf_counter() - t0:.1f}"
                 f" s on a host thread beside the data -> "
                 f"{os.path.relpath(DK.group_library_path())}"]
        from torch.utils.cpp_extension import CUDA_HOME
        cuobjdump = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
        if CUDA_HOME and os.path.exists(cuobjdump):
            so = DK.group_library_path()
            sass = subprocess.run([cuobjdump, "-sass", so],
                                  capture_output=True, text=True).stdout
            ops = {}
            for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+|ATOM\.[A-Z0-9.]+|"
                                 r"RED\.[A-Z0-9.]+|SHFL\.[A-Z]+|MATCH\.[A-Z.]+)",
                                 sass):
                ops[op] = ops.get(op, 0) + 1
            res = subprocess.run([cuobjdump, "-res-usage", so],
                                 capture_output=True, text=True).stdout
            lines.append(
                f"build: tile_group_reduce SASS atomics/shuffles {ops}; "
                + " | ".join(" ".join(line.split())
                             for line in res.splitlines()
                             if "REG" in line or "Function" in line))
        return lines
    kernel_build = references_ahead([("nvcc", build)])

    # --- data: three tables, chunk by chunk onto the card --------------------
    t0 = time.perf_counter()
    batches = {n: [] for n in HOST_COLS}
    host = tpch_host_lanes(np, lambda name, chunk: batches[name].append(
        table_to_batch(chunk, device=dev)))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev)
    log(f"data: lineitem {ROWS}, orders {ROWS // 4}, customer {ROWS // 40} "
        f"rows in {[len(b) for b in batches.values()]} batches on {dev}, "
        f"{resident / 1e9:.3f} GB resident, generated+moved in "
        f"{gen_s:.1f} s")
    t = time.perf_counter()
    try:
        for line in kernel_build.get("nvcc"):
            log(line)
    finally:
        kernel_build.close()
    log(f"build: waited {time.perf_counter() - t:.1f} s after the data")
    li, od, cu = host["lineitem"], host["orders"], host["customer"]
    for key in ("rf", "ls"):
        hs = li[key]
        check(bool(np.all(hs.lengths() == 1)), f"l_{key} is one byte")

    conf = SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS})
    session = TpuSession(conf, device=dev)
    dfs = {n: session.from_batches(b) for n, b in batches.items()}
    df = dfs["lineitem"]
    b0 = batches["lineitem"][0]

    # --- kernel phase: B1 tile_reduce and its string lane B2 -----------------
    # the read rate one torch reduction reaches with a cold L2: what a
    # kernel near its byte bound can hope for on this card
    big = torch.rand(1 << 25, dtype=torch.float64, device=dev)
    t = cold_device_ms(torch, big.sum)
    log(f"read rate: torch.sum over {big.numel() * 8} B, cold {t:.4f} ms = "
        f"{big.numel() * 8 / t / 1e9:.3f} TB/s")
    del big

    def hold_b1(label, plan, batch):
        arrays = plan.kernel_inputs(batch)
        t = time.perf_counter()
        got = DK.tile_reduce(arrays, plan.program, plan.kinds)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t
        ref = DK.tile_reduce_plain(arrays, plan.program, plan.kinds)
        err = (got - ref).abs()
        finite = torch.isfinite(ref)
        ok = torch.equal(torch.isnan(got), torch.isnan(ref)) and bool(
            torch.all(torch.where(finite, err <= RTOL * ref.abs(),
                                  got == ref) | torch.isnan(ref)))
        check(ok, f"tile_reduce {label}: kernel {got.tolist()} vs plain "
              f"{ref.tolist()}")
        max_err = float(torch.where(finite, err, 0.0).max())
        ms = device_ms(torch, lambda: DK.tile_reduce(arrays, plan.program,
                                                     plan.kinds))
        plain = device_ms(torch, lambda: DK.tile_reduce_plain(
            arrays, plan.program, plan.kinds))
        n = batch.capacity
        # each scalar lane and the live mask read once, the partials
        # written once; per string column its offsets and validity read
        # once (offsets[i + 1] is row i + 1's offsets[i]) and per row at
        # most the longest literal's bytes of chars
        k = 2 * len(plan.ref_names)
        nbytes = sum(a.numel() * a.element_size() for a in arrays[:k]) \
            + n + 8 * len(plan.kinds)
        for j, name in enumerate(plan.str_names):
            offsets, _chars, validity = arrays[k + 3 * j:k + 3 * j + 3]
            m = max(len(c) for p in str_preds(plan.pred) if p.name == name
                    for c in p.choices)
            lens = batch.column(name).lengths()
            nbytes += offsets.numel() * offsets.element_size() \
                + validity.numel() * validity.element_size() \
                + int(torch.clamp(lens, max=m).sum())
        nodes = (count_nodes(plan.pred) if plan.pred is not None else 0) + \
            sum(count_nodes(b[1]) for b in plan.program.builders
                if b[1] is not None) + len(plan.kinds)
        bms, by = bound_ms(nbytes, n * nodes)
        log(f"tile_reduce[{label}]: matches plain (max_abs_err {max_err:.3e}),"
            f" first call {compile_s:.2f} s, kernel_ms {ms:.4f}, plain_ms "
            f"{plain:.4f}, bound_ms {bms:.4f} ({by}, {nbytes} B)")
        cold = cold_device_ms(torch, lambda: DK.tile_reduce(
            arrays, plan.program, plan.kinds))
        again = DK.tile_reduce(arrays, plan.program, plan.kinds)
        log(f"  tile_reduce[{label}]: cold_ms {cold:.4f}, two runs bit-equal "
            f"{torch.equal(got, again)}")
        check(torch.equal(got, again), f"tile_reduce {label}: two runs differ")
        return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "cold_ms": cold,
                "bit_equal": torch.equal(got, again)}

    def str_preds(e):
        if isinstance(e, DK.StrPred):
            yield e
        for c in e.children:
            yield from str_preds(c)

    def fused_plan(query, frame):
        plan = query(frame).plan          # Aggregate <- Filter <- relation
        filt = plan.children[0]
        check(pallas_agg.pred_safe(filt.condition, filt.schema),
              "predicate fuses into tile_reduce")
        return pallas_agg.PallasAggPlan(plan.agg_exprs, filt.schema,
                                        filt.condition)

    q6_plan = fused_plan(tpch.q6, df)
    b1 = hold_b1("q6", q6_plan, b0)
    nan_batch = b0.select(b0.names)
    qty = nan_batch.column("l_quantity")
    qdata = qty.data.clone()
    qdata[::997] = float("nan")
    nan_batch.columns[nan_batch.names.index("l_quantity")] = \
        type(qty)(qdata, qty.validity, qty.dtype)
    mm_plan = pallas_agg.PallasAggPlan(
        [(Agg.Min(col("l_quantity")), "mn"),
         (Agg.Max(col("l_quantity")), "mx"),
         (Agg.Min(col("l_shipdate")), "first_ship"),
         (Agg.Count(col("l_tax") / (col("l_discount") - 0.05)), "n")],
        b0.schema(), (col("l_tax") > 0.02) | (col("l_quantity") < 10.0))
    b1_mm = hold_b1("minmax_nan", mm_plan, nan_batch)
    li_plan = fused_plan(li_str, df)
    check(li_plan.str_names == ["l_linestatus", "l_returnflag"],
          f"lineitem string lanes {li_plan.str_names}")
    b2 = hold_b1("strings_lineitem", li_plan, b0)
    od_plan = fused_plan(ord_str, dfs["orders"])
    check(od_plan.str_names == ["o_orderpriority"],
          f"orders string lanes {od_plan.str_names}")
    b2_od = hold_b1("strings_orders", od_plan, batches["orders"][0])

    def hold_b3(label, gid, lanes, groups, plain=True, library=False):
        """tile_group_reduce (told the group count) against its plain
        version on one shape, two runs compared bit for bit, then timed;
        the bound counts every id and the values of rows below
        ``groups`` (the rows the function needs)."""
        def kernel():
            return DK.tile_group_reduce(gid, lanes, num_groups=groups)
        got = torch.stack(kernel())
        again = torch.stack(kernel())
        ref = torch.stack(DK.tile_group_reduce_plain(gid, lanes))
        check(torch.allclose(got, ref, rtol=RTOL, atol=0.0),
              f"tile_group_reduce[{label}] disagrees with its plain version")
        live = int((gid < groups).sum())
        nbytes = gid.numel() * 4 + live * 8 * len(lanes) \
            + len(lanes) * DK.GROUP_BUCKETS * 8
        r = {"rows": gid.numel(), "lanes": len(lanes), "groups": groups,
             "max_abs_err": float((got - ref).abs().max()),
             "bit_equal": torch.equal(got, again),
             "ms": device_ms(torch, kernel),
             "cold_ms": cold_device_ms(torch, kernel),
             "plain_ms": device_ms(torch, lambda: DK.tile_group_reduce_plain(
                 gid, lanes)) if plain else None,
             "library_ms": None}
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, live * len(lanes))
        if library:
            stacked = torch.stack(lanes, dim=1)
            gid64 = gid.to(torch.int64)
            r["library_ms"] = device_ms(torch, lambda: torch.zeros(
                DK.GROUP_BUCKETS, len(lanes), dtype=torch.float64,
                device=dev).index_add_(0, gid64, stacked))
            del stacked, gid64
        log(f"tile_group_reduce[{label}]: {len(lanes)} lanes, {groups} "
            f"groups, {live} of {gid.numel()} rows live; matches plain "
            f"(max_abs_err {r['max_abs_err']:.3e}), two runs bit-equal "
            f"{r['bit_equal']}; kernel_ms {r['ms']:.4f}, cold_ms "
            f"{r['cold_ms']:.4f}, plain_ms {untimed(r['plain_ms'])}, "
            f"library_ms {untimed(r['library_ms'])} (index_add_), "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, {nbytes} B)")
        check(r["bit_equal"], f"tile_group_reduce[{label}]: two runs differ")
        return r

    # --- kernel phase: B3 tile_group_reduce at q1's shapes -------------------
    def q1_inputs():
        """B3's inputs for q1's first batch: (gid, lanes, groups)."""
        q1_agg = tpch.q1(df).plan.children[0]  # Sort <- Aggregate <- Filter
        q1_filter = q1_agg.children[0]
        kept = K.filter_batch(b0, q1_filter.condition.eval(b0))
        key_cols = [e.eval(kept) for e in q1_agg.group_exprs]
        agg_in = [fn.children[0].eval(kept) if fn.children else None
                  for fn, _ in q1_agg.agg_exprs]
        fns = [fn for fn, _ in q1_agg.agg_exprs]
        claimed, prelude = K._prelude_fast(kept, key_cols)
        check(claimed, "hash-claim grouping resolves q1's keys")
        gid, lanes = K.grouped_kernel_inputs(kept, prelude[2], agg_in, fns,
                                             DK.GROUP_BUCKETS)
        check(len(lanes) == 15 and gid.shape[0] == BATCH_ROWS,
              f"q1 gives {len(lanes)} lanes of {gid.shape[0]} rows")
        return gid, lanes, prelude[3]

    gid, lanes, n_groups = q1_inputs()
    b3 = hold_b3("q1", gid, lanes, n_groups, library=True)

    # --- kernel phase: B3 at shapes that stress its design -------------------
    rng = np.random.default_rng(3)

    def lanes_of(k, n=BATCH_ROWS):
        """k value lanes: prices and 0/1 counts, as the grouped lane has"""
        return [torch.from_numpy(rng.uniform(0, 1e5, n) if j % 2 == 0 else
                                 (rng.random(n) > 0.3).astype(np.float64)
                                 ).to(dev) for j in range(k)]

    def ids_of(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    n = BATCH_ROWS
    runs = np.sort((rng.zipf(1.3, n) - 1) % 600)
    runs[-n // 7:] = 600                  # dead rows on the scratch id
    stress = {
        "one_group": (ids_of(np.zeros(n)), lanes_of(15), 1),
        "uniform_1024": (ids_of(rng.integers(0, 1024, n)), lanes_of(2),
                         1024),
        "sorted_runs": (ids_of(runs), lanes_of(2), 600),
        "one_lane": (ids_of(rng.integers(0, 6, n)), lanes_of(1), 6),
        "lanes_17": (ids_of(rng.integers(0, 1024, n)), lanes_of(17), 1024),
        "lanes_40": (ids_of(rng.integers(0, 6, n)), lanes_of(40), 6),
    }
    dead = stress["sorted_runs"][0] == 600
    for v in stress["sorted_runs"][1]:
        v[dead] = 0.0                     # dead rows carry zeros
    b3_stress = {}
    for label, (sgid, slanes, groups) in stress.items():
        b3_stress[label] = hold_b3(label, sgid, slanes, groups, plain=False)
    del stress, dead, gid, lanes, sgid, slanes

    # --- hashing on the card gives the CPU's bits ----------------------------
    ob0 = batches["orders"][0]
    hash_cols = [b0.column(n) for n in ("l_orderkey", "l_returnflag",
                                        "l_extendedprice", "l_shipdate")]
    cpu_b0 = [table_to_batch(generate_chunk(tpch.tpch_table_specs(ROWS)[0],
                                            0, BATCH_ROWS), device="cpu")]
    cpu_cols = [cpu_b0[0].column(n) for n in ("l_orderkey", "l_returnflag",
                                              "l_extendedprice",
                                              "l_shipdate")]
    check(torch.equal(H.murmur3_row_hash(hash_cols).cpu(),
                      H.murmur3_row_hash(cpu_cols)),
          "murmur3 on the card differs from the CPU")
    okeys = [ob0.column("o_orderkey"), ob0.column("o_orderdate")]
    cpu_ob0 = table_to_batch(generate_chunk(tpch.tpch_table_specs(ROWS)[1],
                                            0, BATCH_ROWS), device="cpu")
    ok_gpu, pre_gpu = K._prelude_fast(ob0, okeys)
    ok_cpu, pre_cpu = K._prelude_fast(
        cpu_ob0, [cpu_ob0.column("o_orderkey"), cpu_ob0.column("o_orderdate")])
    check(ok_gpu == ok_cpu and pre_gpu[3] == pre_cpu[3]
          and torch.equal(pre_gpu[2].cpu(), pre_cpu[2]),
          "hash-claim grouping on the card differs from the CPU")
    log(f"hashing: murmur3 row hash and hash-claim gids ({pre_gpu[3]} groups,"
        f" resolved {ok_gpu}) on the card equal the CPU's")
    del cpu_b0, cpu_cols, cpu_ob0, pre_gpu, pre_cpu

    t = time.perf_counter()
    (ref6, ref1, ref_li, ref_od, ref3, q3_pairs), _, ref_s, _ = \
        refs_worker.get("tpch")
    log(f"numpy reference: {ref_s:.1f} s in a second process (waited "
        f"{time.perf_counter() - t:.1f} s); q1 groups "
        f"{[(r['l_returnflag'], r['l_linestatus']) for r in ref1]}; q3 "
        f"joins {q3_pairs} lineitem rows; q3 top order keys "
        f"{[r['o_orderkey'] for r in ref3]}")

    def read_counts():
        return {"tile_reduce": DK.tile_reduce.launches,
                "tile_reduce_str": DK.tile_reduce.str_launches,
                "tile_group_reduce": DK.tile_group_reduce.launches}

    launches = {}
    resident_rows = {}

    def run_query(name, make, ref, rows_in, expect, at_least=None):
        """A checked run (counts reset just before, read just after;
        every B1 / B3 launch held against the plain version), then
        three timed runs outside the hold; ``expect`` maps launch
        counters to the counts each run must give, ``at_least`` to a
        least count. Returns the operator metrics and the hold."""
        at_least = at_least or {}
        DK.reset_counts()
        torch.cuda.synchronize()
        with holding_launches(torch, DK) as hold:
            rows = make().collect()
        counts = read_counts()
        check_held(hold, counts, name)
        metrics = session._last_execution[1].metric_totals()
        check(same_rows(rows, ref), f"{name}: {rows} != numpy {ref}")
        for key, n in expect.items():
            check(counts[key] == n, f"{name}: {key} launched {counts[key]} "
                  f"times, expected {n}")
        for key, n in at_least.items():
            check(counts[key] >= n, f"{name}: {key} launched {counts[key]} "
                  f"times, expected at least {n}")
        launches[name] = counts
        resident_rows[name] = rows
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(3):
            DK.reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = make().collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            check(same_rows(rows, ref), f"{name}: timed run disagrees")
            now = read_counts()
            check(all(now[k] == n for k, n in expect.items())
                  and all(now[k] >= n for k, n in at_least.items()),
                  f"{name}: timed run launched {now}")
        wall = statistics.median(walls)
        log(f"{name}: matches numpy over {rows_in} rows; launches {counts}; "
            f"wall s median {wall:.4f} of {[round(w, 4) for w in walls]}; "
            f"rows/s {rows_in / wall:.4e}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
        return metrics, hold

    n_li, n_od = len(batches["lineitem"]), len(batches["orders"])
    run_query("q6", lambda: tpch.q6(df), ref6, ROWS,
              {"tile_reduce": n_li, "tile_reduce_str": 0})
    run_query("q1", lambda: tpch.q1(df), ref1, ROWS,
              {"tile_group_reduce": n_li})
    run_query("strings_lineitem", lambda: li_str(df), ref_li, ROWS,
              {"tile_reduce_str": n_li})
    run_query("strings_orders", lambda: ord_str(dfs["orders"]), ref_od,
              ROWS // 4, {"tile_reduce_str": n_od})
    # q3's partial aggregate takes B3 for join output batches of at most
    # 1024 groups (the hot keys' chunks), the hash path for the rest
    q3_metrics, q3_hold = run_query(
        "q3", lambda: tpch.q3(dfs["customer"], dfs["orders"], df), ref3,
        ROWS, {"tile_reduce": 0}, at_least={"tile_group_reduce": 1})
    log("q3 operators: " + ", ".join(
        f"{k}={q3_metrics.get(k, 0)}" for k in (
            "joinOverflowRetries", "joinSubPartitions",
            "joinSubPartitionSkew", "bloomFilteredRows", "claimResolved",
            "claimFallbacks", "pallasBatches")))
    q3_last = session._last_execution  # the last timed q3 run

    # --- kernel phase: B3 tile_group_reduce at q3's shapes -------------------
    # q3's partial aggregate hands the kernel the join output batches that
    # the hash-claim prelude resolves to at most 1024 groups; the checked
    # run held each one and kept the widest
    b3_q3 = {"err": q3_hold.err["tile_group_reduce"]}
    rows3, groups3, gid3, lanes3 = q3_hold.widest
    b3_widest = hold_b3(f"q3 widest, {rows3} rows", gid3, lanes3, groups3,
                        library=True)
    del q3_hold, gid3, lanes3

    # --- phase 5g: the Parquet scan and writer --------------------------------
    scan = scan_phase(torch, np, dev, host, dfs, scan_queries(
        (ref6, ref1, ref_li, ref_od, ref3), n_li, n_od), resident_rows,
        read_counts, plan_guard, host_lib, scan_dir, types_w)
    scan_runs = {q: r for q, r in scan.items()
                 if isinstance(r, dict) and "launches" in r}

    # --- phase 5h: Delta Lake tables and the mortgage ETL ---------------------
    delta = delta_phase(torch, np, dev, read_counts)
    # the NDS tables' host batches, on a host thread from here to the NDS
    # phase
    nds_ahead = nds_batches_ahead()
    delta_runs = {q: r for q, r in delta.items()
                  if isinstance(r, dict) and "launches" in r}

    # --- the scalar expression library on the same tables ------------------
    # the nested phase's orders_nested on a host thread from here
    nested_ahead = references_ahead([("nested_host", lambda:
                                      nested_host_build(np, host))])
    log(f"scalar: {zone_why}")
    scalar = scalar_phase(torch, np, dev, session, dfs, zone, refs_worker,
                          read_counts)

    # --- phase 5c: TPC-H over DECIMAL(12,2) money -----------------------------
    dec_report, dec_session, run_d1, ref_d1 = decimal_phase(
        torch, np, dev, batches, host, read_counts, refs_worker)

    # --- NDS: the star-join slice through session.sql (before phases 5d
    # and 5f, whose orders_json documents a second process builds
    # meanwhile) ---------------------------------------------------------------
    try:
        nds, nds_session, nds_ref, nds_widest, joins_ahead = nds_phase(
            torch, np, dev, read_counts, nds_ahead)
    finally:
        nds_ahead.close()
    rows_n, groups_n, gid_n, lanes_n, q_n = nds_widest
    b3_nds = hold_b3(f"nds {q_n} widest, {rows_n} rows", gid_n, lanes_n,
                     groups_n, library=True)
    b3_nds["query"] = q_n
    del nds_widest, gid_n, lanes_n

    # the windows' numpy references, on a host thread from here on
    windows_ahead = references_ahead(
        [("windows", lambda: numpy_windows(np, nds_ref))])
    d5_ahead = references_ahead(
        [("d5", lambda: decimal_window_reference(np, nds_ref))])
    # memory phase (a)'s stable sort of store_sales, from here on its own
    # host thread too
    ooc_ahead = references_ahead(
        [("ooc_sort", lambda: ooc_sort_reference(np, nds_ref))])

    # --- the float group sums alone, at q12's and q98's widest batch --------
    seg_sum_timing(torch, dev, nds_session)

    # --- phase 5d: nested types, higher-order functions, JSON ---------------
    nested, run_n2, ref_n2, nested_batches = nested_phase(
        torch, np, dev, session, df, nested_ahead, json_worker, read_counts)
    json_worker.close()

    # --- phase 5f: ANSI mode, the DataFrame surface, the rest of the
    # expression library --------------------------------------------------
    surface = surface_phase(torch, np, dev, session, batches, host,
                            dec_session, nested_batches, refs_worker,
                            read_counts, (ref6, ref1), launches, plan_guard)
    surface_runs = {q: r for q, r in surface.items()
                    if isinstance(r, dict) and "launches" in r}

    # --- phase 5e: mixed device / CPU-engine plans --------------------------
    plan_guard["allow"] = True
    try:
        fallback = fallback_phase(
            torch, np, dev, {"float": session, "decimal": dec_session,
                             "nds": nds_session},
            batches["lineitem"], read_counts, refs_worker, nds_ref)
    finally:
        plan_guard["allow"] = False
        refs_worker.close()

    # --- outer, keyless and nested-loop joins, set operations -------------
    joins, joins_widest = joins_setops_phase(torch, np, dev, nds_session,
                                             nds_ref, joins_ahead,
                                             read_counts)
    rows_j, groups_j, gid_j, lanes_j, q_j = joins_widest
    b3_joins = hold_b3(f"nds {q_j} widest, {rows_j} rows", gid_j, lanes_j,
                       groups_j, library=True)
    b3_joins["query"] = q_j
    del joins_widest, gid_j, lanes_j

    # --- subquery predicates, ROLLUP, round and stddev --------------------
    subq, subq_widest = subquery_rollup_phase(torch, np, dev, nds_session,
                                              nds_ref, read_counts)
    rows_s, groups_s, gid_s, lanes_s, q_s = subq_widest
    b3_subq = hold_b3(f"nds {q_s} widest, {rows_s} rows", gid_s, lanes_s,
                      groups_s, library=True)
    b3_subq["query"] = q_s
    del subq_widest, gid_s, lanes_s

    # --- windows over all of store_sales, on the SF10 session ---------------
    _, window_runs, window_want = window_phase(torch, np, dev, nds_session,
                                               nds_ref, windows_ahead)
    # D5 of phase 5c: the decimal window on the same store_sales rows
    dec_report["d5_window"] = decimal_window_phase(
        torch, np, dev, nds_session, read_counts, d5_ahead)

    # --- memory: out-of-core sort, caps, injected OOM, spill rate ----------
    def runs_of(make, ref, kernel):
        return (lambda: make().collect()), ref, kernel, same_rows
    try:
        memory, memory_launches = memory_phase(
            torch, np, dev, nds_session, nds_ref, ooc_ahead, session, {
                "q1": runs_of(lambda: tpch.q1(df), ref1, "tile_group_reduce"),
                "q6": runs_of(lambda: tpch.q6(df), ref6, "tile_reduce"),
                "strings_lineitem": runs_of(lambda: li_str(df), ref_li,
                                            "tile_reduce"),
                "q3": runs_of(lambda: tpch.q3(dfs["customer"], dfs["orders"],
                                              df), ref3, None)},
            window_runs["a_running"], window_want, read_counts)
    finally:
        ooc_ahead.close()

    # --- where q3's time goes ------------------------------------------------
    physical, ctx = q3_last
    self_ms = operator_self_ms(physical, ctx.metrics, {})
    log("q3 operator self time (host clock, ms, last timed run): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(self_ms.items(),
                                          key=lambda kv: -kv[1])))
    # nested N2 (the lambdas and the fold): device time by kernel; the
    # q3 and decimal D1 profiles are cut to keep the smoke in its time
    rows = profiled(torch, "nested N2", run_n2)
    check(len(rows) == 1 and nested_same(rows[0], ref_n2),
          "nested N2: profiled run disagrees")
    del dec_session, run_d1, ref_d1, run_n2, nested_batches
    # window (a) profiled in core: its window and sort without the
    # out-of-core merge, whose time memory phase (a) logs
    with memory_conf(torch, dev, nds_session,
                     {"srt.sql.sort.oocRowBudget": IN_CORE_ROW_BUDGET}):
        table = profiled(torch, "window a_running (in core)",
                         window_runs["a_running"])
    same_columns(np, table, window_want["a_running"],
                 "window a_running (profiled)")
    del nds_session, nds_ref, window_runs, window_want, table

    log(f"planner: {plan_guard['plans']} plans outside phase 5e and phase "
        "5f's exact percentile and JSON queries, each "
        "wholly on the device")
    scan_vals = list(scan_runs.values()) + list(delta_runs.values())
    b2_launches = launches["strings_lineitem"]["tile_reduce_str"] + \
        launches["strings_orders"]["tile_reduce_str"]
    def b3_extra(r):
        return {k: r[k] for k in ("rows", "lanes", "groups", "ms", "cold_ms",
                                  "bound_ms", "plain_ms", "library_ms",
                                  "bit_equal")}
    kernels = [
        {"name": "tile_reduce", "route": "triton",
         "source": "spark_rapids_tpu_torch/ops/device_kernels.py",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:78",
         "launches": launches["q6"]["tile_reduce"]
         + sum(r["launches"]["tile_reduce"]
               for r in (*nds.values(), *joins.values(), *subq.values(),
                         *scalar.values(), *nested.values(),
                         *fallback.values(), *surface_runs.values()))
         + sum(r["launches"]["tile_reduce"] - r["launches"]["tile_reduce_str"]
               for r in scan_vals)
         + memory_launches["tile_reduce"]
         - memory_launches["tile_reduce_str"],
         "scan_launches": {q: r["launches"]["tile_reduce"]
                           - r["launches"]["tile_reduce_str"]
                           for q, r in scan_runs.items()
                           if r["launches"]["tile_reduce"]
                           - r["launches"]["tile_reduce_str"]},
         "delta_launches": {q: r["launches"]["tile_reduce"]
                            - r["launches"]["tile_reduce_str"]
                            for q, r in delta_runs.items()
                            if r["launches"]["tile_reduce"]
                            - r["launches"]["tile_reduce_str"]},
         "surface_launches": {q: r["launches"]["tile_reduce"]
                              for q, r in surface_runs.items()
                              if r["launches"]["tile_reduce"]},
         "scalar_launches": {q: r["launches"]["tile_reduce"]
                             for q, r in scalar.items()
                             if r["launches"]["tile_reduce"]},
         "nested_launches": {q: r["launches"]["tile_reduce"]
                             for q, r in nested.items()
                             if r["launches"]["tile_reduce"]},
         "fallback_launches": {q: r["launches"]["tile_reduce"]
                               for q, r in fallback.items()
                               if r["launches"]["tile_reduce"]},
         "memory_launches": memory_launches["tile_reduce"]
         - memory_launches["tile_reduce_str"],
         "nds_launches": {q: r["launches"]["tile_reduce"]
                          for q, r in (*nds.items(), *joins.items(),
                                       *subq.items())
                          if r["launches"]["tile_reduce"]},
         **{k: b1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "cold_ms", "bit_equal")},
         "library_ms": None,
         "minmax_nan": {k: b1_mm[k] for k in ("ms", "cold_ms", "bound_ms",
                                              "bit_equal")}},
        {"name": "tile_reduce_string_lane", "route": "triton",
         "source": "spark_rapids_tpu_torch/ops/device_kernels.py",
         "replaces": "spark_rapids_tpu/exec/pallas_agg.py:60",
         "launches": b2_launches + memory_launches["tile_reduce_str"]
         + sum(r["launches"]["tile_reduce_str"]
               for r in (*nested.values(), *surface_runs.values(),
                         *scan_vals)),
         "memory_launches": memory_launches["tile_reduce_str"],
         "scan_launches": {q: r["launches"]["tile_reduce_str"]
                           for q, r in scan_runs.items()
                           if r["launches"]["tile_reduce_str"]},
         "delta_launches": {q: r["launches"]["tile_reduce_str"]
                            for q, r in delta_runs.items()
                            if r["launches"]["tile_reduce_str"]},
         **{k: b2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "cold_ms", "bit_equal")},
         "library_ms": None,
         "orders": {k: b2_od[k] for k in ("ms", "cold_ms", "plain_ms",
                                          "bound_ms", "bit_equal")}},
        {"name": "tile_group_reduce", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/tile_group_reduce.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:152",
         "launches": launches["q1"]["tile_group_reduce"]
         + launches["q3"]["tile_group_reduce"]
         + sum(r["launches"]["tile_group_reduce"]
               for r in (*nds.values(), *joins.values(), *subq.values(),
                         *scalar.values(), *nested.values(),
                         *fallback.values(), *surface_runs.values(),
                         *scan_vals))
         + memory_launches["tile_group_reduce"],
         "scan_launches": {q: r["launches"]["tile_group_reduce"]
                           for q, r in scan_runs.items()
                           if r["launches"]["tile_group_reduce"]},
         "delta_launches": {q: r["launches"]["tile_group_reduce"]
                            for q, r in delta_runs.items()
                            if r["launches"]["tile_group_reduce"]},
         "surface_launches": {q: r["launches"]["tile_group_reduce"]
                              for q, r in surface_runs.items()
                              if r["launches"]["tile_group_reduce"]},
         "scalar_launches": {q: r["launches"]["tile_group_reduce"]
                             for q, r in scalar.items()
                             if r["launches"]["tile_group_reduce"]},
         "nested_launches": {q: r["launches"]["tile_group_reduce"]
                             for q, r in nested.items()
                             if r["launches"]["tile_group_reduce"]},
         "fallback_launches": {q: r["launches"]["tile_group_reduce"]
                               for q, r in fallback.items()
                               if r["launches"]["tile_group_reduce"]},
         "memory_launches": memory_launches["tile_group_reduce"],
         "nds_launches": {q: r["launches"]["tile_group_reduce"]
                          for q, r in (*nds.items(), *joins.items(),
                                       *subq.items())
                          if r["launches"]["tile_group_reduce"]},
         "max_abs_err": max(b3["max_abs_err"], b3_q3["err"],
                            *(r["b3_max_abs_err"] for r in
                              (*nds.values(), *joins.values(),
                               *subq.values()))),
         **{k: b3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "cold_ms", "bit_equal")},
         "q3_widest": b3_extra(b3_widest),
         "nds_widest": {"query": b3_nds["query"], **b3_extra(b3_nds)},
         "joins_widest": {"query": b3_joins["query"],
                          **b3_extra(b3_joins)},
         "subquery_rollup_widest": {"query": b3_subq["query"],
                                    **b3_extra(b3_subq)},
         "stress": {k: b3_extra(r) for k, r in b3_stress.items()}},
    ]
    # B1 on the NDS batches it took (the global aggregates under q28, q38,
    # q61, q87 and q90, and under the plan-time subqueries of phase 6c)
    held_err = [r["max_abs_err"] for r in (*memory["injected"].values(),
                                            *scalar.values(),
                                            *nested.values(),
                                            *fallback.values(),
                                            *surface_runs.values(),
                                            *scan_vals)]
    kernels[0]["max_abs_err"] = max(
        kernels[0]["max_abs_err"],
        *(r["b1_max_abs_err"] for r in (*nds.values(), *joins.values(),
                                        *subq.values())),
        *(e["tile_reduce"] for e in held_err))
    kernels[2]["max_abs_err"] = max(
        kernels[2]["max_abs_err"],
        *(e["tile_group_reduce"] for e in held_err))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
