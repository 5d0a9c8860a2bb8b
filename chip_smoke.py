#!/usr/bin/env python3
"""Chip smoke for spark_rapids_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA GPU (built for an H100: sm_90a), nvcc and triton. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's kernels from the sources in this checkout into
   spark_rapids_tpu_torch/build/ (nvcc for tile_group_reduce; Triton
   compiles each tile_reduce program at its first launch);
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
   computation over the same host data; for q3 it also logs each
   operator's self time and, from one run under torch.profiler, the
   device time by kernel and the device's idle share;
6. runs the NDS slice (``NDS_SLICE``, 20 star-join queries) as SQL
   text through ``session.sql`` over NDS tables generated in memory at
   ``scale_rows`` 28,800,000 (TPC-DS SF10's store_sales; q82 at
   2,880,000, SF1, because its join grows with the square of the scale)
   and moved to the card: per query one first run and three warm runs,
   each held against a numpy reference written from the query text
   (``NdsNumpy``) and checked to be in ORDER BY order; it logs wall
   times, fact rows/s, result rows, launches and ``pallasBatches`` per
   kernel and peak device memory, and checks that B3 carried q3, q42,
   q43, q52 and q55;
7. profiles one TPC-H q3 and one NDS q3 run (torch.profiler: device
   time by kernel and the device's idle share), then logs the device
   kernels that one call of each kernel launches (profiles last,
   because every profiler session slows the host's later launches);
8. prints one JSON line of kernel numbers, then
   {"ok": true, "device": {...}} as its last line.

Any mismatch or error exits non-zero before the last line is printed.
"""

import datetime
import gc
import json
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


def kernel_profile(torch, fn, calls=20):
    """What one ``fn()`` call runs on the device, from torch.profiler
    over ``calls`` calls: {kernel name: (launches per call, device us per
    call)}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            n, t = out.get(e.key, (0.0, 0.0))
            out[e.key] = (n + e.count / calls, t + us / calls)
    return out


def log_profile(label, prof):
    """Logs a kernel_profile and returns the CUDA launches per call: each
    kernel's count rounded, as the profiler can drop a few events at the
    edges of its window (0.9 per call where the wrapper launches one)."""
    log(f"  profile {label}: " + "; ".join(
        f"{n:.2f} x {name[:60]} {us:.2f} us"
        for name, (n, us) in sorted(prof.items(), key=lambda kv: -kv[1][1])))
    return sum(round(n) for n, _ in prof.values())


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP64_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def untimed(ms):
    return "not timed" if ms is None else f"{ms:.4f}"


def count_nodes(expr):
    return 1 + sum(count_nodes(c) for c in expr.children)


def days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def operator_self_ms(node, metrics, out):
    """{operator: self time in ms} from the host-clock opTime metrics,
    which include the time a node spends pulling its children."""
    def incl(n):
        m = metrics.get(n.exec_id, {}).get("opTime")
        return m.value if m is not None else 0
    name = node.node_description().split("[")[0]
    key, k = name, 2
    while key in out:
        key, k = f"{name}#{k}", k + 1
    out[key] = (incl(node) - sum(incl(c) for c in node.children)) / 1e6
    for c in node.children:
        operator_self_ms(c, metrics, out)
    return out


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

    def col(self, table, name):
        """(values, valid) of one column; strings as an object array."""
        key = (table, name)
        if key not in self._cols:
            c = self.tables[table].column(name)
            values = c.values.to_objects() if hasattr(c.values, "to_objects") \
                else c.values
            self._cols[key] = (values, c.mask)
        return self._cols[key]

    def rows(self, table):
        return self.tables[table].num_rows

    # --- relational pieces ------------------------------------------------
    def lookup(self, dim, dim_key, fact_key, fact_ok):
        """Row of ``dim`` whose (unique, non-null) key equals each fact
        key, and whether there is one."""
        np = self.np
        keys, _ = self.col(dim, dim_key)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
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
        for values, ok in keys:
            if values.dtype == object:
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

    def result(self, cols, order, limit=None):
        """Rows of ``cols`` ({name: (values, valid)} in SELECT order),
        sorted by ``order`` ([(name, ascending)], Spark's null order)
        through np.lexsort and cut to ``limit``."""
        np = self.np
        names = list(cols)
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
            if idx is None:
                # a whole fact column against a dimension: several
                # queries share it
                key = (fact, fk, dim, dk)
                if key not in self._full_lookups:
                    self._full_lookups[key] = self.lookup(dim, dk, v, ok)
                pos, hit = self._full_lookups[key]
                hit = hit.copy()
                idx = np.arange(len(v))
            else:
                pos, hit = self.lookup(dim, dk, v[idx], ok[idx])
            if dim_keep is not None:
                hit &= dim_keep[pos]
            idx = idx[hit]
            rows = {d: p[hit] for d, p in rows.items()}
            rows[dim] = pos[hit]
        return idx, rows

    def take(self, table, name, rows):
        values, ok = self.col(table, name)
        return values[rows], ok[rows]

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


def b3_on_batches(torch, physical, conf, dev, label, launched):
    """Holds B3 against its plain version on every batch that the plan's
    partial aggregate hands the grouped lane: its child subtree runs
    again and each batch the hash-claim prelude resolves to at most 1024
    groups goes through both. Checks that as many batches take the lane
    as the main path launched; returns their rows, groups and lanes, the
    largest error and the widest batch (rows, groups, gid, lanes)."""
    from spark_rapids_tpu_torch.exec.aggregate import (PARTIAL,
                                                       HashAggregateExec)
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.ops import kernels as K

    def partial_agg(node):
        if isinstance(node, HashAggregateExec) and node.mode == PARTIAL:
            return node
        return next(filter(None, map(partial_agg, node.children)), None)

    agg = partial_agg(physical)
    check(agg is not None, f"{label} has a partial aggregate")
    fns = [fn for fn, _ in agg.agg_exprs]
    out = {"batches": 0, "rows": [], "groups": [], "lanes": 0, "err": 0.0,
           "widest": None}
    for batch in agg.children[0].execute(ExecContext(conf, dev)):
        if batch.num_rows == 0:
            continue
        key_cols, agg_in = agg._eval_update_inputs(batch)
        prelude, _, kernel_in = K.grouped_lane_inputs(batch, key_cols, agg_in,
                                                      fns)
        if kernel_in is None:
            continue
        gid, lanes = kernel_in
        groups = max(prelude[3], 1)
        got = torch.stack(DK.tile_group_reduce(gid, lanes, num_groups=groups))
        ref = torch.stack(DK.tile_group_reduce_plain(gid, lanes))
        check(torch.allclose(got, ref, rtol=RTOL, atol=0.0),
              f"tile_group_reduce disagrees with its plain version on "
              f"{label} batch {out['batches']} ({batch.num_rows} rows)")
        out["err"] = max(out["err"], float((got - ref).abs().max()))
        out["batches"] += 1
        out["rows"].append(batch.num_rows)
        out["groups"].append(prelude[3])
        out["lanes"] = len(lanes)
        if out["widest"] is None or batch.num_rows > out["widest"][0]:
            out["widest"] = (batch.num_rows, groups, gid, lanes)
    check(out["batches"] == launched,
          f"{out['batches']} {label} batches take the grouped lane, the "
          f"main path launched {launched}")
    log(f"tile_group_reduce[{label}]: {out['batches']} batches "
        f"({out['lanes']} lanes, {min(out['rows'])}-{max(out['rows'])} "
        f"rows, {min(out['groups'])}-{max(out['groups'])} groups) match "
        f"plain (max_abs_err {out['err']:.3e})")
    return out


def nds_phase(torch, np, dev, read_counts):
    """The NDS slice through ``session.sql`` on the card, each run held
    against NdsNumpy; returns ({query: numbers}, the SF10 session, its
    reference)."""
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models.nds import (NDS_QUERIES, NDS_SLICE,
                                                   register_nds)
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.testing import compare_rows, order_keys
    from spark_rapids_tpu_torch.plan.session import TpuSession

    def load(scale):
        session = TpuSession(SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS}),
                             device=dev)
        host = {}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        register_nds(session, scale, host_tables=host)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        nbytes = torch.cuda.memory_allocated(dev) - before
        log(f"nds data, scale_rows {scale}: " + ", ".join(
            f"{n} {t.num_rows}" for n, t in host.items()
            if n in NDS_FACTS) + f"; {sum(t.num_rows for t in host.values())}"
            f" rows in {len(host)} tables, {nbytes / 1e9:.3f} GB on the "
            f"card, generated and moved in {secs:.1f} s")
        return session, NdsNumpy(np, host)

    def run(q, session, ref):
        text = NDS_QUERIES[q]
        t = time.perf_counter()
        want = getattr(ref, q)()
        ref_s = time.perf_counter() - t
        facts = sum(ref.rows(f) for f in NDS_FACTS
                    if re.search(rf"\b{f}\b", text))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        DK.reset_counts()
        t = time.perf_counter()
        df = session.sql(text)
        rows = df.collect()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        counts = read_counts()
        pb = session._last_execution[1].metric_totals().get(
            "pallasBatches", 0)
        keys, limit = order_keys(text, df.columns)
        diff = compare_rows(rows, want, keys, limit, RTOL)
        check(diff is None, f"nds {q}: {diff} (numpy reference)")
        walls = []
        for _ in range(3):
            DK.reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = session.sql(text).collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            check(compare_rows(rows, want, keys, limit, RTOL) is None,
                  f"nds {q}: a warm run disagrees")
            check(read_counts() == counts,
                  f"nds {q}: a warm run launched {read_counts()}, the "
                  f"first {counts}")
        wall = statistics.median(walls)
        physical, ctx = session._last_execution
        self_ms = sorted(operator_self_ms(physical, ctx.metrics, {}).items(),
                         key=lambda kv: -kv[1])
        b3_err = 0.0
        if counts["tile_group_reduce"]:
            b3 = b3_on_batches(torch, session._last_execution[0],
                               session.conf, dev, f"nds {q}",
                               counts["tile_group_reduce"])
            b3_err = b3["err"]
            if widest[0] is None or b3["widest"][0] > widest[0][0]:
                widest[0] = b3["widest"] + (q,)
            del b3
        out = {"first_s": first, "warm_s": wall, "b3_max_abs_err": b3_err,
               "warm_runs_s": walls, "fact_rows": facts,
               "fact_rows_per_s": facts / wall, "result_rows": len(rows),
               "launches": counts, "pallas_batches": pb,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "reference_s": ref_s}
        log(f"nds {q}: matches numpy ({len(rows)} rows); first "
            f"{first:.4f} s, warm median {wall:.4f} of "
            f"{[round(w, 4) for w in walls]} s; {facts} fact rows, "
            f"{facts / wall:.4e} rows/s; launches {counts}, pallasBatches "
            f"{pb}; max_memory_allocated {out['peak_gb']:.3f} GB; numpy "
            f"{ref_s:.1f} s")
        log(f"nds {q} operator self time (host clock, ms, last warm run): "
            + ", ".join(f"{k} {v:.1f}" for k, v in self_ms[:5]))
        return out

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
    for q in NDS_SLICE:
        report[q] = q82 if q == "q82" else run(q, session, ref)
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
    return report, session, ref, widest[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.exec import pallas_agg
    from spark_rapids_tpu_torch.exec.aggregate import (PARTIAL,
                                                       HashAggregateExec)
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.expr import aggregates as Agg
    from spark_rapids_tpu_torch.expr import hashing as H
    from spark_rapids_tpu_torch.expr.core import Alias, col, lit
    from spark_rapids_tpu_torch.expr.predicates import InSet, IsNotNull
    from spark_rapids_tpu_torch.expr.strings import StartsWith
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
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if CUDA_HOME and os.path.exists(cuobjdump):
        so = DK.group_library_path()
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                              text=True).stdout
        ops = {}
        for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+|ATOM\.[A-Z0-9.]+|"
                             r"RED\.[A-Z0-9.]+|SHFL\.[A-Z]+|MATCH\.[A-Z.]+)",
                             sass):
            ops[op] = ops.get(op, 0) + 1
        res = subprocess.run([cuobjdump, "-res-usage", so],
                             capture_output=True, text=True).stdout
        log(f"build: tile_group_reduce SASS atomics/shuffles {ops}; "
            + " | ".join(" ".join(line.split()) for line in res.splitlines()
                         if "REG" in line or "Function" in line))

    # --- data: three tables, chunk by chunk onto the card --------------------
    t0 = time.perf_counter()
    host = {}
    host_cols = {
        "lineitem": {"qty": "l_quantity", "price": "l_extendedprice",
                     "disc": "l_discount", "tax": "l_tax",
                     "ship": "l_shipdate", "okey": "l_orderkey"},
        "orders": {"okey": "o_orderkey", "ckey": "o_custkey",
                   "total": "o_totalprice", "odate": "o_orderdate"},
        "customer": {"ckey": "c_custkey"}}
    host_strs = {"lineitem": {"rf": "l_returnflag", "ls": "l_linestatus"},
                 "orders": {"prio": "o_orderpriority"},
                 "customer": {"seg": "c_mktsegment"}}
    batches = {}
    for spec in tpch.tpch_table_specs(ROWS):
        name = spec.name
        lanes = {k: [] for k in list(host_cols[name]) + list(host_strs[name])}
        batches[name] = []
        for c in range(-(-spec.num_rows // BATCH_ROWS)):
            chunk = generate_chunk(spec, c, BATCH_ROWS)
            for key, cname in host_cols[name].items():
                lanes[key].append(chunk.column(cname).values)
            for key, cname in host_strs[name].items():
                lanes[key].append(chunk.column(cname).values)
            batches[name].append(table_to_batch(chunk, device=dev))
        host[name] = {k: (np.concatenate(v) if k in host_cols[name]
                          else type(v[0]).concat(v))
                      for k, v in lanes.items()}
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev)
    log(f"data: lineitem {ROWS}, orders {ROWS // 4}, customer {ROWS // 40} "
        f"rows in {[len(b) for b in batches.values()]} batches on {dev}, "
        f"{resident / 1e9:.3f} GB resident, generated+moved in "
        f"{gen_s:.1f} s")
    li, od, cu = host["lineitem"], host["orders"], host["customer"]
    for key in ("rf", "ls"):
        hs = li[key]
        check(bool(np.all(hs.lengths() == 1)), f"l_{key} is one byte")

    conf = SrtConf({"srt.sql.batchSizeRows": BATCH_ROWS})
    session = TpuSession(conf, device=dev)
    dfs = {n: session.from_batches(b) for n, b in batches.items()}
    df = dfs["lineitem"]
    b0 = batches["lineitem"][0]

    # --- the string-filtered global aggregates (B2's main path) --------------
    def li_str(lineitem):
        return (lineitem
                .filter(InSet(col("l_returnflag"), ["A", "R"])
                        & (col("l_linestatus") == "F")
                        & (col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                        & (col("l_shipdate") < lit(datetime.date(1995, 1, 1))))
                .agg(Alias(Agg.Sum(col("l_extendedprice")
                                   * col("l_discount")), "revenue"),
                     Alias(Agg.CountStar(), "n")))

    def ord_str(orders):
        return (orders
                .filter((StartsWith(col("o_orderpriority"), "1-")
                         | (col("o_orderpriority") == "2-HIGH"))
                        & IsNotNull(col("o_orderpriority"))
                        & (col("o_orderdate")
                           < lit(datetime.date(1995, 3, 15))))
                .agg(Alias(Agg.Sum(col("o_totalprice")), "total"),
                     Alias(Agg.CountStar(), "n")))

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
    b1_programs = {"q6": (q6_plan, b0), "minmax_nan": (mm_plan, nan_batch),
                   "strings_lineitem": (li_plan, b0),
                   "strings_orders": (od_plan, batches["orders"][0])}
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

    # --- numpy references ----------------------------------------------------
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

    t = time.perf_counter()
    ref6, ref1 = numpy_q6(), numpy_q1()
    ref_li, ref_od = numpy_li_str(), numpy_ord_str()
    ref3, q3_pairs = numpy_q3()
    log(f"numpy reference: {time.perf_counter() - t:.1f} s; q1 groups "
        f"{[(r['l_returnflag'], r['l_linestatus']) for r in ref1]}; q3 "
        f"joins {q3_pairs} lineitem rows; q3 top order keys "
        f"{[r['o_orderkey'] for r in ref3]}")

    def read_counts():
        return {"tile_reduce": DK.tile_reduce.launches,
                "tile_reduce_str": DK.tile_reduce.str_launches,
                "tile_group_reduce": DK.tile_group_reduce.launches}

    launches = {}

    def run_query(name, make, ref, rows_in, expect, at_least=None):
        """A checked run (counts reset just before, read just after),
        then three timed runs; ``expect`` maps launch counters to the
        counts each run must give, ``at_least`` to a least count."""
        at_least = at_least or {}
        DK.reset_counts()
        torch.cuda.synchronize()
        rows = make().collect()
        counts = read_counts()
        metrics = session._last_execution[1].metric_totals()
        check(same_rows(rows, ref), f"{name}: {rows} != numpy {ref}")
        for key, n in expect.items():
            check(counts[key] == n, f"{name}: {key} launched {counts[key]} "
                  f"times, expected {n}")
        for key, n in at_least.items():
            check(counts[key] >= n, f"{name}: {key} launched {counts[key]} "
                  f"times, expected at least {n}")
        launches[name] = counts
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
        return metrics

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
    q3_metrics = run_query(
        "q3", lambda: tpch.q3(dfs["customer"], dfs["orders"], df), ref3,
        ROWS, {"tile_reduce": 0}, at_least={"tile_group_reduce": 1})
    log("q3 operators: " + ", ".join(
        f"{k}={q3_metrics.get(k, 0)}" for k in (
            "joinOverflowRetries", "joinSubPartitions",
            "joinSubPartitionSkew", "bloomFilteredRows", "claimResolved",
            "claimFallbacks", "pallasBatches")))

    # --- kernel phase: B3 tile_group_reduce at q3's shapes -------------------
    # q3's partial aggregate hands the kernel the join output batches that
    # the hash-claim prelude resolves to at most 1024 groups
    b3_q3 = b3_on_batches(torch, session._last_execution[0], conf, dev,
                          "q3", launches["q3"]["tile_group_reduce"])
    widest = b3_q3["widest"]
    rows3, groups3, gid3, lanes3 = widest
    b3_widest = hold_b3(f"q3 widest, {rows3} rows", gid3, lanes3, groups3,
                        library=True)
    del widest, b3_q3["widest"]

    # --- NDS: the star-join slice through session.sql -------------------------
    nds, nds_session, nds_ref, nds_widest = nds_phase(torch, np, dev,
                                                      read_counts)
    rows_n, groups_n, gid_n, lanes_n, q_n = nds_widest
    b3_nds = hold_b3(f"nds {q_n} widest, {rows_n} rows", gid_n, lanes_n,
                     groups_n, library=True)
    b3_nds["query"] = q_n
    del nds_widest, gid_n, lanes_n

    # --- where q3's time goes ------------------------------------------------
    physical, ctx = session._last_execution  # the last timed q3 run
    self_ms = operator_self_ms(physical, ctx.metrics, {})
    log("q3 operator self time (host clock, ms, last timed run): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(self_ms.items(),
                                          key=lambda kv: -kv[1])))
    def profiled(label, run):
        """One run under torch.profiler: its device time by kernel and
        the device's idle share; returns the run's rows."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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

    rows = profiled("q3", lambda: tpch.q3(dfs["customer"], dfs["orders"],
                                          df).collect())
    check(same_rows(rows, ref3), "q3: profiled run disagrees")
    from spark_rapids_tpu_torch.models.nds import NDS_QUERIES
    from spark_rapids_tpu_torch.testing import compare_rows, order_keys
    nds_q3 = nds_session.sql(NDS_QUERIES["q3"])
    rows = profiled("nds q3", nds_q3.collect)
    check(compare_rows(rows, nds_ref.q3(), *order_keys(
        NDS_QUERIES["q3"], nds_q3.columns), RTOL) is None,
        "nds q3: profiled run disagrees")
    del nds_session, nds_ref, nds_q3

    # --- what one kernel call launches ---------------------------------------
    # last: each torch.profiler session leaves the host's launches slower
    # for the rest of the process, which would skew the query walls
    per_call = {}
    for label, (plan, batch) in b1_programs.items():
        arrays = plan.kernel_inputs(batch)
        per_call[label] = log_profile(f"tile_reduce[{label}]", kernel_profile(
            torch, lambda: DK.tile_reduce(arrays, plan.program, plan.kinds)))
    for label, (gid, lanes, groups) in (("q1", q1_inputs()),
                                        ("q3 widest", (gid3, lanes3,
                                                       groups3))):
        per_call[label] = log_profile(
            f"tile_group_reduce[{label}]", kernel_profile(
                torch, lambda: DK.tile_group_reduce(gid, lanes,
                                                    num_groups=groups)))
    b1["cuda_launches_per_call"] = per_call["q6"]
    b2["cuda_launches_per_call"] = per_call["strings_lineitem"]
    b3["cuda_launches_per_call"] = per_call["q1"]

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
         + sum(r["launches"]["tile_reduce"] for r in nds.values()),
         **{k: b1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "cold_ms", "bit_equal",
                               "cuda_launches_per_call")},
         "library_ms": None,
         "minmax_nan": {k: b1_mm[k] for k in ("ms", "cold_ms", "bound_ms",
                                              "bit_equal")}},
        {"name": "tile_reduce_string_lane", "route": "triton",
         "source": "spark_rapids_tpu_torch/ops/device_kernels.py",
         "replaces": "spark_rapids_tpu/exec/pallas_agg.py:60",
         "launches": b2_launches,
         **{k: b2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "cold_ms", "bit_equal",
                               "cuda_launches_per_call")},
         "library_ms": None,
         "orders": {k: b2_od[k] for k in ("ms", "cold_ms", "plain_ms",
                                          "bound_ms", "bit_equal")}},
        {"name": "tile_group_reduce", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/tile_group_reduce.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:152",
         "launches": launches["q1"]["tile_group_reduce"]
         + launches["q3"]["tile_group_reduce"]
         + sum(r["launches"]["tile_group_reduce"] for r in nds.values()),
         "nds_launches": {q: r["launches"]["tile_group_reduce"]
                          for q, r in nds.items()
                          if r["launches"]["tile_group_reduce"]},
         "max_abs_err": max(b3["max_abs_err"], b3_q3["err"],
                            *(r["b3_max_abs_err"] for r in nds.values())),
         **{k: b3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "cold_ms", "bit_equal",
                               "cuda_launches_per_call")},
         "q3_widest": b3_extra(b3_widest),
         "nds_widest": {"query": b3_nds["query"], **b3_extra(b3_nds)},
         "stress": {k: b3_extra(r) for k, r in b3_stress.items()}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
