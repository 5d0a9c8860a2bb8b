#!/usr/bin/env python3
"""Chip smoke for spark_rapids_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA GPU (built for an H100: sm_90a), nvcc and triton. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's kernels from the sources in this checkout into
   spark_rapids_tpu_torch/build/ (nvcc for tile_group_reduce; Triton
   compiles each tile_reduce program at its first launch);
3. holds each kernel against its plain PyTorch version on the card at the
   shapes TPC-H q6 / q1 give it (tile_reduce at q6 and once more with a
   min/max/NaN program, tile_group_reduce at q1: 1,048,576 rows, 15
   lanes, 1024 buckets), and times kernel, plain version, bound and, for
   tile_group_reduce, one ``index_add_`` call as the library yardstick;
4. generates a 60,000,000-row TPC-H lineitem (SF10 size) in 1,048,576-row
   chunks, moves each chunk to the card once, and runs q6 and q1 through
   TpuSession: a checked run with the launch counts set to 0 just before
   and read just after, then three timed runs; each result is held
   against an independent numpy computation over the same host data;
5. prints one JSON line of kernel numbers, then
   {"ok": true, "device": {...}} as its last line.

Any mismatch or error exits non-zero before the last line is printed.
"""

import datetime
import json
import os
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP64_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def count_nodes(expr):
    return 1 + sum(count_nodes(c) for c in expr.children)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.datagen import generate_chunk, lineitem_spec
    from spark_rapids_tpu_torch.exec import pallas_agg
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr.core import col
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    from spark_rapids_tpu_torch.plan.session import TpuSession

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- build --------------------------------------------------------------
    t0 = time.perf_counter()
    DK.build_group_kernel()
    log(f"build: nvcc tile_group_reduce {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(DK.group_library_path())}")

    # --- data: 60M rows, chunk by chunk onto the card ------------------------
    t0 = time.perf_counter()
    spec = lineitem_spec(ROWS)
    n_chunks = -(-ROWS // BATCH_ROWS)
    host = {k: [] for k in ("qty", "price", "disc", "tax", "ship", "rf",
                            "ls")}
    batches = []
    for c in range(n_chunks):
        chunk = generate_chunk(spec, c, BATCH_ROWS)
        for key, name in (("qty", "l_quantity"), ("price", "l_extendedprice"),
                          ("disc", "l_discount"), ("tax", "l_tax"),
                          ("ship", "l_shipdate")):
            host[key].append(chunk.column(name).values)
        for key, name in (("rf", "l_returnflag"), ("ls", "l_linestatus")):
            hs = chunk.column(name).values
            check(bool(np.all(hs.lengths() == 1)), f"{name} is one byte")
            host[key].append(hs.chars[hs.offsets[:-1]])
        batches.append(table_to_batch(chunk, device=dev))
    host = {k: np.concatenate(v) for k, v in host.items()}
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev)
    log(f"data: {ROWS} rows in {len(batches)} batches on {dev}, "
        f"{resident / 1e9:.3f} GB resident, generated+moved in {gen_s:.1f} s")

    conf = SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS})
    session = TpuSession(conf, device=dev)
    df = session.from_batches(batches)

    # --- kernel phase: B1 tile_reduce at q6's shapes ------------------------
    b0 = batches[0]
    q6_plan = tpch.q6(df).plan             # Aggregate <- Filter <- relation
    filt = q6_plan.children[0]

    def b1_inputs(plan, batch):
        arrays = []
        for n in plan.ref_names:
            c = batch.column(n)
            arrays += [c.data, c.validity.view(torch.uint8)]
        return arrays + [batch.live_mask().view(torch.uint8)]

    def hold_b1(label, plan, batch):
        arrays = b1_inputs(plan, batch)
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
        nbytes = sum(a.numel() * a.element_size() for a in arrays) \
            + 8 * len(plan.kinds)
        nodes = (count_nodes(plan.pred) if plan.pred is not None else 0) + \
            sum(count_nodes(b[1]) for b in plan.program.builders
                if b[1] is not None) + len(plan.kinds)
        bms, by = bound_ms(nbytes, batch.capacity * nodes)
        log(f"tile_reduce[{label}]: matches plain (max_abs_err {max_err:.3e}),"
            f" first call {compile_s:.2f} s, kernel_ms {ms:.4f}, plain_ms "
            f"{plain:.4f}, bound_ms {bms:.4f} ({by}, {nbytes} B)")
        return max_err, ms, plain, bms, by

    q6_fused = pallas_agg.PallasAggPlan(q6_plan.agg_exprs, filt.schema,
                                        filt.condition)
    b1 = hold_b1("q6", q6_fused, b0)
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
        filt.schema, (col("l_tax") > 0.02) | (col("l_quantity") < 10.0))
    hold_b1("minmax_nan", mm_plan, nan_batch)

    # --- kernel phase: B3 tile_group_reduce at q1's shapes -------------------
    q1_plan = tpch.q1(df).plan             # Sort <- Aggregate <- Filter <- rel
    q1_agg = q1_plan.children[0]
    q1_filter = q1_agg.children[0]
    kept = K.filter_batch(b0, q1_filter.condition.eval(b0))
    key_cols = [e.eval(kept) for e in q1_agg.group_exprs]
    agg_in = [fn.children[0].eval(kept) if fn.children else None
              for fn, _ in q1_agg.agg_exprs]
    fns = [fn for fn, _ in q1_agg.agg_exprs]
    perm, _live_s, gid_s, n_groups, _kb = K._prelude_exact(kept, key_cols)
    gid, lanes = K.grouped_kernel_inputs(kept, perm, gid_s, agg_in, fns,
                                         DK.GROUP_BUCKETS)
    check(len(lanes) == 15 and gid.shape[0] == BATCH_ROWS,
          f"q1 gives {len(lanes)} lanes of {gid.shape[0]} rows")
    got = torch.stack(DK.tile_group_reduce(gid, lanes))
    torch.cuda.synchronize()
    ref = torch.stack(DK.tile_group_reduce_plain(gid, lanes))
    check(torch.allclose(got, ref, rtol=RTOL, atol=0.0),
          "tile_group_reduce disagrees with its plain version")
    b3_err = float((got - ref).abs().max())
    b3_ms = device_ms(torch, lambda: DK.tile_group_reduce(gid, lanes))
    b3_plain = device_ms(torch, lambda: DK.tile_group_reduce_plain(gid, lanes))
    stacked = torch.stack(lanes, dim=1)
    gid64 = gid.to(torch.int64)
    b3_lib = device_ms(torch, lambda: torch.zeros(
        DK.GROUP_BUCKETS, len(lanes), dtype=torch.float64,
        device=dev).index_add_(0, gid64, stacked))
    nbytes = gid.numel() * 4 + sum(v.numel() * 8 for v in lanes) \
        + len(lanes) * DK.GROUP_BUCKETS * 8
    b3_bound, b3_by = bound_ms(nbytes, gid.numel() * len(lanes))
    log(f"tile_group_reduce[q1]: {n_groups} groups, matches plain "
        f"(max_abs_err {b3_err:.3e}), kernel_ms {b3_ms:.4f}, plain_ms "
        f"{b3_plain:.4f}, library_ms {b3_lib:.4f} (index_add_), bound_ms "
        f"{b3_bound:.4f} ({b3_by}, {nbytes} B)")
    del stacked, gid64, kept, key_cols, agg_in, lanes, got, ref

    # --- q6 and q1 through TpuSession ----------------------------------------
    def days(y, m, d):
        return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days

    def numpy_q6():
        m = ((host["ship"] >= days(1994, 1, 1))
             & (host["ship"] < days(1995, 1, 1)) & (host["disc"] >= 0.05)
             & (host["disc"] <= 0.07) & (host["qty"] < 24.0))
        return [{"revenue": float(np.sum(host["price"][m] * host["disc"][m]))}]

    def numpy_q1():
        m = host["ship"] <= days(1998, 9, 2)
        code = host["rf"][m].astype(np.int64) * 256 + host["ls"][m]
        keys, g = np.unique(code, return_inverse=True)
        price, disc = host["price"][m], host["disc"][m]
        qty, tax = host["qty"][m], host["tax"][m]
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

    def same_rows(got, ref):
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

    launches = {}

    def run_query(name, query, ref, kernel_fn):
        DK.reset_counts()
        torch.cuda.synchronize()
        rows = query(df).collect()
        counts = (DK.tile_reduce.launches, DK.tile_group_reduce.launches)
        check(same_rows(rows, ref), f"{name}: {rows} != numpy {ref}")
        check(kernel_fn.launches == len(batches),
              f"{name}: {kernel_fn.__name__} launched {kernel_fn.launches} "
              f"times for {len(batches)} batches")
        launches[kernel_fn.__name__] = kernel_fn.launches
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(3):
            DK.reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = query(df).collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            check(same_rows(rows, ref), f"{name}: timed run disagrees")
            check(kernel_fn.launches == len(batches),
                  f"{name}: timed run launched {kernel_fn.launches}")
        wall = statistics.median(walls)
        log(f"{name}: matches numpy over {ROWS} rows; launches "
            f"(tile_reduce, tile_group_reduce) = {counts}; wall s median "
            f"{wall:.4f} of {[round(w, 4) for w in walls]}; rows/s "
            f"{ROWS / wall:.4e}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
        return rows

    t = time.perf_counter()
    ref6, ref1 = numpy_q6(), numpy_q1()
    log(f"numpy reference: {time.perf_counter() - t:.1f} s; q1 groups "
        f"{[(r['l_returnflag'], r['l_linestatus']) for r in ref1]}")
    run_query("q6", tpch.q6, ref6, DK.tile_reduce)
    run_query("q1", tpch.q1, ref1, DK.tile_group_reduce)

    kernels = [
        {"name": "tile_reduce", "route": "triton",
         "source": "spark_rapids_tpu_torch/ops/device_kernels.py",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:78",
         "launches": launches["tile_reduce"], "max_abs_err": b1[0],
         "ms": b1[1], "plain_ms": b1[2], "bound_ms": b1[3],
         "bound_by": b1[4], "library_ms": None},
        {"name": "tile_group_reduce", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/tile_group_reduce.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:152",
         "launches": launches["tile_group_reduce"], "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": b3_lib},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
