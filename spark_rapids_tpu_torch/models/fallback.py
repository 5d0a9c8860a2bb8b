"""The fallback phase's queries: mixed device / CPU-engine plans.

F1-F6 run on the TPC-H tables (F3 on DECIMAL(12,2) money as Spark's
TPC-H schemas type it, the rest on the float money columns, which the
kernels sum) and the NDS tables (F5). Each sends one operator to the CPU engine for a reason
the planner states (plan/overrides.py), and ``CPU_NODES`` names the
logical nodes ``explain("NOT_ON_TPU")`` must mark ``!`` (F6 runs with
``srt.sql.enabled=false``: every node goes to the CPU engine, while
the tagging marks none). Device filters cut what crosses each seam to
about one month of rows.
"""

from __future__ import annotations

#: F1: group references in a regexp_replace replacement
#: (``_tag_regexp_replace``) over a quarter's orders; the aggregate above
#: runs on the device, on the rows a HostToDevice seam brings back. The
#: port's lineitem, like the JAX package's generator it copies, has no
#: l_shipmode: o_orderpriority ('1-URGENT' -> '1-RGENTU') is the string
#: column with words, and a quarter of orders is about a month of
#: lineitem's rows
F1 = r"""
    SELECT p, COUNT(*) AS n, SUM(o_totalprice) AS total
    FROM (SELECT regexp_replace(o_orderpriority, '(\w)(\w*)', '$2$1')
                     AS p, o_totalprice
          FROM orders
          WHERE o_orderdate >= date '1995-01-01'
            AND o_orderdate < date '1995-04-01') x
    GROUP BY p ORDER BY p"""

#: F2: a conjunct over a DECIMAL(20,2) cast to STRING (``_tag_cast``)
#: above q6's conjuncts; the global aggregate runs on the device
F2 = """
    SELECT SUM(l_extendedprice * l_discount) AS revenue, COUNT(*) AS n
    FROM lineitem
    WHERE l_shipdate >= date '1994-01-01' AND l_shipdate < date '1994-02-01'
      AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24
      AND CAST(CAST(l_extendedprice AS DECIMAL(20,2)) AS STRING)
          LIKE '%5.%'"""

#: F3: a DECIMAL(20,2) GROUP BY key (``_tag_agg``) over the money
#: columns; the port sorts a DECIMAL(p>18) on the device (the JAX
#: planner sends that Sort to its CPU engine too)
F3 = """
    SELECT CAST(l_quantity AS DECIMAL(20,2)) AS q, COUNT(*) AS n,
           SUM(l_discount) AS disc
    FROM lineitem
    WHERE l_shipdate >= date '1995-06-01' AND l_shipdate < date '1995-07-01'
    GROUP BY CAST(l_quantity AS DECIMAL(20,2))
    ORDER BY q"""

#: F4: an orders-lineitem key whose common type, DECIMAL(21,3), passes 18
#: digits (C16's DECIMAL(18,0) = DECIMAL(10,3) shape, the lineitem side
#: widened to DECIMAL(12,3) so that SF10's order keys fit): the join runs
#: on the CPU engine (``_tag_join``), the grouped aggregate above it on
#: the device (a float sum, which the grouped kernel takes)
F4 = """
    SELECT o_orderpriority, COUNT(*) AS n, SUM(l_quantity) AS qty
    FROM orders JOIN lineitem
      ON CAST(o_orderkey AS DECIMAL(18,0)) = CAST(l_orderkey AS DECIMAL(12,3))
    WHERE o_orderdate >= date '1995-01-01' AND o_orderdate < date '1995-02-01'
      AND l_shipdate >= date '1995-01-01' AND l_shipdate < date '1995-03-01'
    GROUP BY o_orderpriority ORDER BY o_orderpriority"""

#: F5: stddev_samp and a string max over windows (``_tag_window``) on
#: store_sales joined with item and date_dim for June 1999, on the
#: device
F5 = """
    SELECT ss_ticket_number, ss_item_sk, i_category,
           stddev_samp(ss_net_paid) OVER (PARTITION BY i_category) AS sd,
           max(i_brand) OVER (PARTITION BY ss_store_sk) AS top_brand
    FROM store_sales
    JOIN item ON ss_item_sk = i_item_sk
    JOIN date_dim ON ss_sold_date_sk = d_date_sk
    WHERE d_year = 1999 AND d_moy = 6"""

#: F6 runs TPC-H q6 and q1 (models/tpch.py) with srt.sql.enabled=false

QUERIES = {"f1": F1, "f2": F2, "f3": F3, "f4": F4, "f5": F5}

#: the logical nodes each query's explain("NOT_ON_TPU") marks ``!``
CPU_NODES = {"f1": ["Project"], "f2": ["Filter"], "f3": ["Aggregate"],
             "f4": ["Join"], "f5": ["Window", "Window"]}


def not_on_device(explain_lines):
    """The node names an ``explain("NOT_ON_TPU")`` marks ``!``, in tree
    order (the physical tree after them is left out)."""
    out = []
    for line in explain_lines:
        text = line.strip()
        if not text.startswith("! "):
            continue
        name = text[2:].split("[", 1)[0]
        if name.startswith("Cpu"):
            break   # the physical tree's CPU nodes follow the marks
        out.append(name)
    return out
