"""NDS (TPC-DS derived) schema, the 99-query power run as SQL text, and
the in-memory table registration of this port.

``nds_specs`` and ``NDS_QUERIES`` are copied verbatim from
spark_rapids_tpu/models/nds.py (the texts are data: each keeps its
original query's join graph, predicate shapes and aggregation pattern in
the engine's SQL dialect). ``NDS_SLICE``, ``NDS_WINDOW``,
``NDS_ALSO_RUNS`` and ``NDS_JOINS_SETOPS`` (outer, semi, anti and
nested-loop joins and set operations) name the 66 queries this port
runs end to end through ``session.sql``. ``register_nds`` generates each
table in memory, in the JAX package's 1<<18-row chunks (the datagen
seeds are per chunk, so the bytes equal the JAX package's), moves it to
the session's device in ``srt.sql.batchSizeRows``-row batches and
registers it as a temp view; there is no parquet step.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

from ..columnar import dtypes as dt
from ..datagen import ColumnSpec, TableSpec, generate_chunk
from ..plan.host_table import HostTable, concat_tables, table_to_batch

#: rows per generated chunk, as the JAX package's register_nds writes them
CHUNK_ROWS = 1 << 18

#: the star-join queries of the first block that need no window
#: function
NDS_SLICE = ("q3", "q7", "q15", "q19", "q21", "q25", "q26", "q37", "q40",
             "q42", "q43", "q48", "q52", "q55", "q62", "q68", "q79", "q82",
             "q96", "q99")

#: the window queries (exec/window.py): a window over grouped rows,
#: OVER (PARTITION BY ...) totals and averages, RANK over an aggregate,
#: a ROWS running sum; q36 also needs ROLLUP and is not here
NDS_WINDOW = ("q12", "q20", "q98", "q53", "q63", "q89", "q47", "q57",
              "q44", "q51")

#: queries that also run end to end through the port, held against the
#: JAX package on the CPU only (no numpy reference on the card yet)
NDS_ALSO_RUNS = ("q9", "q13", "q24", "q29", "q31", "q34", "q46", "q50",
                 "q58", "q59", "q64", "q65", "q72", "q73", "q83", "q84",
                 "q85", "q91")

#: the queries that need outer, keyless and nested-loop joins or set
#: operations and nothing else the port lacks: a left outer join (q93),
#: a full outer join (q97), cross products of one-row aggregates (q28,
#: q61, q88, q90), UNION ALL (q4, q11, q33, q54, q56, q60, q66, q71, q74,
#: q76), INTERSECT (q38) and EXCEPT (q87)
NDS_JOINS_SETOPS = ("q93", "q97", "q28", "q61", "q88", "q90", "q4", "q11",
                    "q33", "q54", "q56", "q60", "q66", "q71", "q74", "q76",
                    "q38", "q87")

# --- schema ---------------------------------------------------------------

_DAYS = 730          # two years of date_dim
_ITEMS = 2000
_STORES = 20
_CUSTOMERS = 5000
_ADDRESSES = 2500
_DEMOS = 1000
_HDEMOS = 144
_PROMOS = 50
_WAREHOUSES = 5


def _sales_money(name, lo=1.0, hi=500.0, null_prob=0.02):
    return ColumnSpec(name, dt.FLOAT64, "uniform", lo=lo, hi=hi,
                      null_prob=null_prob)


def nds_specs(scale_rows: int):
    """TableSpecs for the query subset's column surface."""
    ss = TableSpec("store_sales", [
        ColumnSpec("ss_sold_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("ss_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("ss_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("ss_cdemo_sk", dt.INT64, "uniform", lo=1, hi=_DEMOS,
                   null_prob=0.02),
        ColumnSpec("ss_hdemo_sk", dt.INT64, "uniform", lo=1, hi=_HDEMOS,
                   null_prob=0.02),
        ColumnSpec("ss_addr_sk", dt.INT64, "uniform", lo=1,
                   hi=_ADDRESSES, null_prob=0.02),
        ColumnSpec("ss_store_sk", dt.INT64, "uniform", lo=1, hi=_STORES,
                   null_prob=0.01),
        ColumnSpec("ss_promo_sk", dt.INT64, "uniform", lo=1, hi=_PROMOS,
                   null_prob=0.05),
        ColumnSpec("ss_ticket_number", dt.INT64, "uniform", lo=1,
                   hi=max(scale_rows // 8, 4)),
        ColumnSpec("ss_sold_time_sk", dt.INT64, "uniform", lo=1,
                   hi=1000, null_prob=0.01),
        ColumnSpec("ss_quantity", dt.INT64, "uniform", lo=1, hi=100),
        _sales_money("ss_wholesale_cost", 1.0, 100.0),
        _sales_money("ss_list_price", 1.0, 200.0),
        _sales_money("ss_sales_price", 1.0, 200.0),
        _sales_money("ss_ext_discount_amt", 0.0, 100.0),
        _sales_money("ss_ext_sales_price"),
        _sales_money("ss_ext_wholesale_cost"),
        _sales_money("ss_ext_list_price", 1.0, 1000.0),
        _sales_money("ss_ext_tax", 0.0, 50.0),
        _sales_money("ss_coupon_amt", 0.0, 50.0),
        _sales_money("ss_net_paid"),
        ColumnSpec("ss_net_profit", dt.FLOAT64, "normal", mean=20.0,
                   std=40.0, null_prob=0.02),
    ], scale_rows)
    sr = TableSpec("store_returns", [
        ColumnSpec("sr_returned_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("sr_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("sr_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("sr_ticket_number", dt.INT64, "uniform", lo=1,
                   hi=max(scale_rows // 8, 4)),
        ColumnSpec("sr_store_sk", dt.INT64, "uniform", lo=1, hi=_STORES,
                   null_prob=0.01),
        ColumnSpec("sr_cdemo_sk", dt.INT64, "uniform", lo=1, hi=_DEMOS,
                   null_prob=0.02),
        ColumnSpec("sr_reason_sk", dt.INT64, "uniform", lo=1, hi=30,
                   null_prob=0.02),
        ColumnSpec("sr_return_quantity", dt.INT64, "uniform", lo=1,
                   hi=40, null_prob=0.02),
        _sales_money("sr_return_amt", 1.0, 300.0),
        _sales_money("sr_net_loss", 1.0, 150.0),
    ], max(scale_rows // 10, 10))
    cs = TableSpec("catalog_sales", [
        ColumnSpec("cs_sold_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("cs_ship_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("cs_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("cs_bill_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("cs_warehouse_sk", dt.INT64, "uniform", lo=1,
                   hi=_WAREHOUSES, null_prob=0.02),
        ColumnSpec("cs_promo_sk", dt.INT64, "uniform", lo=1, hi=_PROMOS,
                   null_prob=0.05),
        ColumnSpec("cs_call_center_sk", dt.INT64, "uniform", lo=1, hi=6,
                   null_prob=0.02),
        ColumnSpec("cs_ship_mode_sk", dt.INT64, "uniform", lo=1, hi=20,
                   null_prob=0.02),
        ColumnSpec("cs_order_number", dt.INT64, "uniform", lo=1,
                   hi=max(scale_rows // 2, 10)),
        ColumnSpec("cs_quantity", dt.INT64, "uniform", lo=1, hi=100),
        _sales_money("cs_wholesale_cost", 1.0, 100.0),
        _sales_money("cs_list_price", 1.0, 300.0),
        _sales_money("cs_sales_price", 1.0, 300.0),
        _sales_money("cs_ext_discount_amt", 0.0, 100.0),
        _sales_money("cs_ext_sales_price"),
        _sales_money("cs_ext_wholesale_cost"),
        _sales_money("cs_ext_ship_cost", 0.0, 80.0),
        _sales_money("cs_ext_list_price", 1.0, 1000.0),
        _sales_money("cs_coupon_amt", 0.0, 50.0),
        ColumnSpec("cs_catalog_page_sk", dt.INT64, "uniform", lo=1,
                   hi=40, null_prob=0.02),
        ColumnSpec("cs_sold_time_sk", dt.INT64, "uniform", lo=1,
                   hi=1000, null_prob=0.01),
        ColumnSpec("cs_net_profit", dt.FLOAT64, "normal", mean=25.0,
                   std=50.0, null_prob=0.02),
    ], max(scale_rows // 2, 10))
    ws = TableSpec("web_sales", [
        ColumnSpec("ws_sold_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("ws_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("ws_bill_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("ws_web_site_sk", dt.INT64, "uniform", lo=1, hi=12,
                   null_prob=0.01),
        ColumnSpec("ws_promo_sk", dt.INT64, "uniform", lo=1, hi=_PROMOS,
                   null_prob=0.05),
        ColumnSpec("ws_order_number", dt.INT64, "uniform", lo=1,
                   hi=max(scale_rows // 4, 10)),
        ColumnSpec("ws_ship_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("ws_warehouse_sk", dt.INT64, "uniform", lo=1,
                   hi=_WAREHOUSES, null_prob=0.02),
        ColumnSpec("ws_web_page_sk", dt.INT64, "uniform", lo=1, hi=20,
                   null_prob=0.02),
        ColumnSpec("ws_sold_time_sk", dt.INT64, "uniform", lo=1,
                   hi=1000, null_prob=0.01),
        ColumnSpec("ws_ship_mode_sk", dt.INT64, "uniform", lo=1, hi=20,
                   null_prob=0.02),
        ColumnSpec("ws_quantity", dt.INT64, "uniform", lo=1, hi=100),
        _sales_money("ws_wholesale_cost", 1.0, 100.0),
        _sales_money("ws_sales_price", 1.0, 300.0),
        _sales_money("ws_ext_discount_amt", 0.0, 100.0),
        _sales_money("ws_ext_sales_price"),
        _sales_money("ws_ext_wholesale_cost"),
        _sales_money("ws_net_paid"),
        _sales_money("ws_ext_ship_cost", 0.0, 80.0),
        _sales_money("ws_list_price", 1.0, 300.0),
        ColumnSpec("ws_ship_hdemo_sk", dt.INT64, "uniform", lo=1,
                   hi=_HDEMOS, null_prob=0.02),
        ColumnSpec("ws_net_profit", dt.FLOAT64, "normal", mean=25.0,
                   std=50.0, null_prob=0.02),
    ], max(scale_rows // 4, 10))
    inv = TableSpec("inventory", [
        ColumnSpec("inv_date_sk", dt.INT64, "uniform", lo=1, hi=_DAYS),
        ColumnSpec("inv_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("inv_warehouse_sk", dt.INT64, "uniform", lo=1,
                   hi=_WAREHOUSES),
        ColumnSpec("inv_quantity_on_hand", dt.INT64, "uniform", lo=0,
                   hi=1000, null_prob=0.02),
    ], max(scale_rows // 4, 10))
    dd = TableSpec("date_dim", [
        ColumnSpec("d_date_sk", dt.INT64, "seq"),
        ColumnSpec("d_date", dt.DATE, "uniform", lo=10000, hi=10730),
        ColumnSpec("d_year", dt.INT64, "choice", choices=[1998, 1999]),
        ColumnSpec("d_moy", dt.INT64, "uniform", lo=1, hi=12),
        ColumnSpec("d_dom", dt.INT64, "uniform", lo=1, hi=28),
        ColumnSpec("d_qoy", dt.INT64, "uniform", lo=1, hi=4),
        ColumnSpec("d_dow", dt.INT64, "uniform", lo=0, hi=6),
        ColumnSpec("d_month_seq", dt.INT64, "uniform", lo=1176,
                   hi=1224),
        ColumnSpec("d_week_seq", dt.INT64, "uniform", lo=5100, hi=5204),
        ColumnSpec("d_day_name", dt.STRING, "choice",
                   choices=["Sunday", "Monday", "Tuesday", "Wednesday",
                            "Thursday", "Friday", "Saturday"]),
    ], _DAYS)
    it = TableSpec("item", [
        ColumnSpec("i_item_sk", dt.INT64, "seq"),
        ColumnSpec("i_item_id", dt.STRING, "seq", fmt="ITEM{:011d}"),
        ColumnSpec("i_item_desc", dt.STRING, "uniform", lo=1, hi=500,
                   fmt="description of item number {} with detail"),
        ColumnSpec("i_brand_id", dt.INT64, "uniform", lo=1, hi=50),
        ColumnSpec("i_brand", dt.STRING, "uniform", lo=1, hi=50,
                   fmt="brand#{}"),
        ColumnSpec("i_class_id", dt.INT64, "uniform", lo=1, hi=16),
        ColumnSpec("i_class", dt.STRING, "uniform", lo=1, hi=16,
                   fmt="class{}"),
        ColumnSpec("i_category_id", dt.INT64, "uniform", lo=1, hi=10),
        ColumnSpec("i_category", dt.STRING, "choice",
                   choices=["Books", "Children", "Electronics", "Home",
                            "Jewelry", "Men", "Music", "Shoes",
                            "Sports", "Women"]),
        ColumnSpec("i_manufact_id", dt.INT64, "uniform", lo=1, hi=20),
        ColumnSpec("i_manufact", dt.STRING, "uniform", lo=1, hi=20,
                   fmt="manufact{}"),
        ColumnSpec("i_manager_id", dt.INT64, "uniform", lo=1, hi=10),
        _sales_money("i_current_price", 1.0, 100.0),
        _sales_money("i_wholesale_cost", 1.0, 80.0),
        ColumnSpec("i_color", dt.STRING, "choice",
                   choices=["red", "blue", "green", "black", "white",
                            "plum", "navy", "orchid", "chiffon"]),
        ColumnSpec("i_size", dt.STRING, "choice",
                   choices=["small", "medium", "large", "extra large",
                            "petite", "economy"]),
    ], _ITEMS)
    st = TableSpec("store", [
        ColumnSpec("s_store_sk", dt.INT64, "seq"),
        ColumnSpec("s_store_id", dt.STRING, "seq", fmt="STORE{:08d}"),
        ColumnSpec("s_store_name", dt.STRING, "uniform", lo=1,
                   hi=_STORES, fmt="store{}"),
        ColumnSpec("s_state", dt.STRING, "choice",
                   choices=["TN", "CA", "TX", "NY", "WA", "GA"]),
        ColumnSpec("s_county", dt.STRING, "uniform", lo=1, hi=8,
                   fmt="county{}"),
        ColumnSpec("s_city", dt.STRING, "uniform", lo=1, hi=12,
                   fmt="city{}"),
        ColumnSpec("s_company_name", dt.STRING, "choice",
                   choices=["Unknown", "ought", "able", "pri"]),
        ColumnSpec("s_gmt_offset", dt.FLOAT64, "choice",
                   choices=[-5.0, -6.0, -7.0, -8.0]),
        ColumnSpec("s_number_employees", dt.INT64, "uniform", lo=200,
                   hi=300),
    ], _STORES)
    cu = TableSpec("customer", [
        ColumnSpec("c_customer_sk", dt.INT64, "seq"),
        ColumnSpec("c_customer_id", dt.STRING, "seq", fmt="CUST{:011d}"),
        ColumnSpec("c_first_name", dt.STRING, "uniform", lo=1, hi=400,
                   fmt="first{}", null_prob=0.02),
        ColumnSpec("c_last_name", dt.STRING, "uniform", lo=1, hi=600,
                   fmt="last{}", null_prob=0.02),
        ColumnSpec("c_current_addr_sk", dt.INT64, "uniform", lo=1,
                   hi=_ADDRESSES),
        ColumnSpec("c_current_cdemo_sk", dt.INT64, "uniform", lo=1,
                   hi=_DEMOS, null_prob=0.02),
        ColumnSpec("c_current_hdemo_sk", dt.INT64, "uniform", lo=1,
                   hi=_HDEMOS, null_prob=0.02),
        ColumnSpec("c_birth_year", dt.INT64, "uniform", lo=1930,
                   hi=1992, null_prob=0.02),
        ColumnSpec("c_birth_month", dt.INT64, "uniform", lo=1, hi=12,
                   null_prob=0.02),
    ], _CUSTOMERS)
    ca = TableSpec("customer_address", [
        ColumnSpec("ca_address_sk", dt.INT64, "seq"),
        ColumnSpec("ca_state", dt.STRING, "choice",
                   choices=["TN", "CA", "TX", "NY", "WA", "GA", "KY",
                            "OH", "VA"], null_prob=0.01),
        ColumnSpec("ca_city", dt.STRING, "uniform", lo=1, hi=60,
                   fmt="city{}"),
        ColumnSpec("ca_county", dt.STRING, "uniform", lo=1, hi=30,
                   fmt="county{}"),
        ColumnSpec("ca_country", dt.STRING, "choice",
                   choices=["United States"]),
        ColumnSpec("ca_gmt_offset", dt.FLOAT64, "choice",
                   choices=[-5.0, -6.0, -7.0, -8.0]),
        ColumnSpec("ca_zip", dt.STRING, "uniform", lo=10000, hi=99999,
                   fmt="{}"),
    ], _ADDRESSES)
    cd = TableSpec("customer_demographics", [
        ColumnSpec("cd_demo_sk", dt.INT64, "seq"),
        ColumnSpec("cd_gender", dt.STRING, "choice", choices=["M", "F"]),
        ColumnSpec("cd_marital_status", dt.STRING, "choice",
                   choices=["M", "S", "D", "W", "U"]),
        ColumnSpec("cd_education_status", dt.STRING, "choice",
                   choices=["Primary", "Secondary", "College",
                            "2 yr Degree", "4 yr Degree", "Advanced "
                            "Degree", "Unknown"]),
        ColumnSpec("cd_purchase_estimate", dt.INT64, "uniform", lo=500,
                   hi=10000),
        ColumnSpec("cd_credit_rating", dt.STRING, "choice",
                   choices=["Low Risk", "Good", "High Risk",
                            "Unknown"]),
        ColumnSpec("cd_dep_count", dt.INT64, "uniform", lo=0, hi=6),
    ], _DEMOS)
    hd = TableSpec("household_demographics", [
        ColumnSpec("hd_demo_sk", dt.INT64, "seq"),
        ColumnSpec("hd_income_band_sk", dt.INT64, "uniform", lo=1,
                   hi=20),
        ColumnSpec("hd_buy_potential", dt.STRING, "choice",
                   choices=[">10000", "5001-10000", "1001-5000",
                            "501-1000", "0-500", "Unknown"]),
        ColumnSpec("hd_dep_count", dt.INT64, "uniform", lo=0, hi=9),
        ColumnSpec("hd_vehicle_count", dt.INT64, "uniform", lo=0, hi=4),
    ], _HDEMOS)
    pr = TableSpec("promotion", [
        ColumnSpec("p_promo_sk", dt.INT64, "seq"),
        ColumnSpec("p_channel_email", dt.STRING, "choice",
                   choices=["Y", "N"]),
        ColumnSpec("p_channel_event", dt.STRING, "choice",
                   choices=["Y", "N"]),
        ColumnSpec("p_channel_dmail", dt.STRING, "choice",
                   choices=["Y", "N"]),
        ColumnSpec("p_channel_tv", dt.STRING, "choice",
                   choices=["Y", "N"]),
    ], _PROMOS)
    wh = TableSpec("warehouse", [
        ColumnSpec("w_warehouse_sk", dt.INT64, "seq"),
        ColumnSpec("w_warehouse_name", dt.STRING, "uniform", lo=1,
                   hi=_WAREHOUSES, fmt="warehouse{}"),
        ColumnSpec("w_state", dt.STRING, "choice",
                   choices=["TN", "CA", "TX"]),
        ColumnSpec("w_warehouse_sq_ft", dt.INT64, "uniform", lo=50_000,
                   hi=1_000_000),
        ColumnSpec("w_city", dt.STRING, "uniform", lo=1, hi=12,
                   fmt="city{}"),
        ColumnSpec("w_county", dt.STRING, "uniform", lo=1, hi=8,
                   fmt="county{}"),
        ColumnSpec("w_country", dt.STRING, "choice",
                   choices=["United States"]),
    ], _WAREHOUSES)
    cr = TableSpec("catalog_returns", [
        ColumnSpec("cr_returned_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("cr_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("cr_order_number", dt.INT64, "uniform", lo=1,
                   hi=max(scale_rows // 2, 10)),
        ColumnSpec("cr_returning_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("cr_call_center_sk", dt.INT64, "uniform", lo=1,
                   hi=6, null_prob=0.02),
        ColumnSpec("cr_catalog_page_sk", dt.INT64, "uniform", lo=1,
                   hi=40, null_prob=0.02),
        ColumnSpec("cr_warehouse_sk", dt.INT64, "uniform", lo=1,
                   hi=_WAREHOUSES, null_prob=0.02),
        ColumnSpec("cr_reason_sk", dt.INT64, "uniform", lo=1, hi=30,
                   null_prob=0.02),
        ColumnSpec("cr_return_quantity", dt.INT64, "uniform", lo=1,
                   hi=40, null_prob=0.02),
        _sales_money("cr_return_amount", 1.0, 300.0),
        _sales_money("cr_net_loss", 1.0, 150.0),
    ], max(scale_rows // 20, 10))
    wr = TableSpec("web_returns", [
        ColumnSpec("wr_returned_date_sk", dt.INT64, "uniform", lo=1,
                   hi=_DAYS, null_prob=0.01),
        ColumnSpec("wr_item_sk", dt.INT64, "uniform", lo=1, hi=_ITEMS),
        ColumnSpec("wr_order_number", dt.INT64, "uniform", lo=1,
                   hi=max(scale_rows // 4, 10)),
        ColumnSpec("wr_returning_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("wr_refunded_customer_sk", dt.INT64, "zipf",
                   cardinality=_CUSTOMERS, null_prob=0.02),
        ColumnSpec("wr_web_page_sk", dt.INT64, "uniform", lo=1, hi=20,
                   null_prob=0.02),
        ColumnSpec("wr_reason_sk", dt.INT64, "uniform", lo=1, hi=30,
                   null_prob=0.02),
        ColumnSpec("wr_return_quantity", dt.INT64, "uniform", lo=1,
                   hi=40, null_prob=0.02),
        _sales_money("wr_return_amt", 1.0, 300.0),
        _sales_money("wr_net_loss", 1.0, 150.0),
    ], max(scale_rows // 40, 10))
    cc = TableSpec("call_center", [
        ColumnSpec("cc_call_center_sk", dt.INT64, "seq"),
        ColumnSpec("cc_call_center_id", dt.STRING, "seq",
                   fmt="CC{:014d}"),
        ColumnSpec("cc_name", dt.STRING, "uniform", lo=1, hi=6,
                   fmt="call center {}"),
        ColumnSpec("cc_manager", dt.STRING, "uniform", lo=1, hi=6,
                   fmt="manager{}"),
        ColumnSpec("cc_county", dt.STRING, "uniform", lo=1, hi=8,
                   fmt="county{}"),
    ], 6)
    web = TableSpec("web_site", [
        ColumnSpec("web_site_sk", dt.INT64, "seq"),
        ColumnSpec("web_site_id", dt.STRING, "seq", fmt="WEB{:013d}"),
        ColumnSpec("web_name", dt.STRING, "uniform", lo=1, hi=12,
                   fmt="site{}"),
    ], 12)
    wp = TableSpec("web_page", [
        ColumnSpec("wp_web_page_sk", dt.INT64, "seq"),
        ColumnSpec("wp_char_count", dt.INT64, "uniform", lo=100,
                   hi=8000),
    ], 20)
    cp = TableSpec("catalog_page", [
        ColumnSpec("cp_catalog_page_sk", dt.INT64, "seq"),
        ColumnSpec("cp_catalog_page_id", dt.STRING, "seq",
                   fmt="CP{:014d}"),
    ], 40)
    rs = TableSpec("reason", [
        ColumnSpec("r_reason_sk", dt.INT64, "seq"),
        ColumnSpec("r_reason_desc", dt.STRING, "uniform", lo=1, hi=30,
                   fmt="reason {}"),
    ], 30)
    sm = TableSpec("ship_mode", [
        ColumnSpec("sm_ship_mode_sk", dt.INT64, "seq"),
        ColumnSpec("sm_type", dt.STRING, "choice",
                   choices=["EXPRESS", "NEXT DAY", "OVERNIGHT",
                            "REGULAR", "TWO DAY", "LIBRARY"]),
        ColumnSpec("sm_carrier", dt.STRING, "choice",
                   choices=["UPS", "FEDEX", "AIRBORNE", "USPS",
                            "DHL", "TBS"]),
    ], 20)
    tdim = TableSpec("time_dim", [
        ColumnSpec("t_time_sk", dt.INT64, "seq"),
        ColumnSpec("t_hour", dt.INT64, "uniform", lo=0, hi=23),
        ColumnSpec("t_minute", dt.INT64, "uniform", lo=0, hi=59),
        ColumnSpec("t_meal_time", dt.STRING, "choice",
                   choices=["breakfast", "lunch", "dinner"],
                   null_prob=0.4),
    ], 1000)
    ib = TableSpec("income_band", [
        ColumnSpec("ib_income_band_sk", dt.INT64, "seq"),
        ColumnSpec("ib_lower_bound", dt.INT64, "uniform", lo=0,
                   hi=190000),
        ColumnSpec("ib_upper_bound", dt.INT64, "uniform", lo=10000,
                   hi=200000),
    ], 20)
    return [ss, sr, cs, ws, inv, dd, it, st, cu, ca, cd, hd, pr, wh,
            cr, wr, cc, web, wp, cp, rs, sm, tdim, ib]



def _batch_tables(spec: TableSpec, per: int) -> Iterator[HostTable]:
    """The table's chunks regrouped into host tables of ``per`` rows
    (the last one shorter)."""
    pending, n = [], 0
    for c in range(-(-spec.num_rows // CHUNK_ROWS)):
        pending.append(generate_chunk(spec, c, CHUNK_ROWS))
        n += pending[-1].num_rows
        while n >= per:
            whole = pending[0] if len(pending) == 1 else \
                concat_tables(pending)
            yield whole.slice(0, per)
            rest = whole.slice(per, whole.num_rows)
            pending, n = ([rest] if rest.num_rows else []), rest.num_rows
    if n:
        yield pending[0] if len(pending) == 1 else concat_tables(pending)


def register_nds(session, scale_rows: int = 20_000,
                 host_tables: Optional[Dict[str, HostTable]] = None) -> None:
    """Generate every table in memory, move it to the session's device
    in ``srt.sql.batchSizeRows``-row batches and register it as a temp
    view. ``host_tables``, when given, receives each table's host copy
    (for references computed outside the engine)."""
    per = session.conf.batch_size_rows
    for spec in nds_specs(scale_rows):
        parts = list(_batch_tables(spec, per))
        batches = [table_to_batch(t, device=session.device) for t in parts]
        session.create_or_replace_temp_view(
            spec.name, session.from_batches(batches, parts[0].schema()))
        if host_tables is not None:
            host_tables[spec.name] = parts[0] if len(parts) == 1 else \
                concat_tables(parts)


# --- the query subset ------------------------------------------------------
# Keys are NDS query ids; texts keep each query's structural shape
# (join graph, predicates, aggregation/window/set-op patterns) in this
# engine's SQL dialect. Substitution parameters are fixed choices.

NDS_QUERIES: Dict[str, str] = {
    # 3-way star join, grouped sum, sort (q3)
    "q3": """
        SELECT d_year, i_brand_id AS brand_id, i_brand AS brand,
               SUM(ss_ext_sales_price) AS sum_agg
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE i_manufact_id = 7 AND d_moy = 11
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, sum_agg DESC, brand_id
        LIMIT 100""",
    # demographics + promotion star join (q7)
    "q7": """
        SELECT i_item_id,
               AVG(ss_quantity) AS agg1, AVG(ss_list_price) AS agg2,
               AVG(ss_coupon_amt) AS agg3, AVG(ss_sales_price) AS agg4
        FROM store_sales
        JOIN customer_demographics ON ss_cdemo_sk = cd_demo_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        JOIN promotion ON ss_promo_sk = p_promo_sk
        WHERE cd_gender = 'M' AND cd_marital_status = 'S'
          AND cd_education_status = 'College'
          AND (p_channel_email = 'N' OR p_channel_event = 'N')
          AND d_year = 1998
        GROUP BY i_item_id
        ORDER BY i_item_id
        LIMIT 100""",
    # window ratio inside category (q12 shape, web channel)
    "q12": """
        SELECT i_item_id, i_item_desc, i_category, i_class,
               i_current_price,
               SUM(ws_ext_sales_price) AS itemrevenue,
               SUM(ws_ext_sales_price) * 100.0 /
                 SUM(SUM(ws_ext_sales_price))
                   OVER (PARTITION BY i_class) AS revenueratio
        FROM web_sales
        JOIN item ON ws_item_sk = i_item_sk
        JOIN date_dim ON ws_sold_date_sk = d_date_sk
        WHERE i_category IN ('Sports', 'Books', 'Home')
          AND d_year = 1999 AND d_moy BETWEEN 2 AND 3
        GROUP BY i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        ORDER BY i_category, i_class, i_item_id, i_item_desc,
                 revenueratio
        LIMIT 100""",
    # customer/address join with geography filter (q15 shape)
    "q15": """
        SELECT ca_zip, SUM(cs_sales_price) AS sum_sales
        FROM catalog_sales
        JOIN customer ON cs_bill_customer_sk = c_customer_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        JOIN date_dim ON cs_sold_date_sk = d_date_sk
        WHERE (ca_state IN ('CA', 'WA', 'GA')
               OR cs_sales_price > 250.0)
          AND d_qoy = 1 AND d_year = 1999
        GROUP BY ca_zip
        ORDER BY ca_zip
        LIMIT 100""",
    # brand revenue by manager/month with store join (q19 shape)
    "q19": """
        SELECT i_brand_id AS brand_id, i_brand AS brand,
               i_manufact_id, i_manufact,
               SUM(ss_ext_sales_price) AS ext_price
        FROM date_dim
        JOIN store_sales ON d_date_sk = ss_sold_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        JOIN store ON ss_store_sk = s_store_sk
        WHERE i_manager_id = 8 AND d_moy = 11 AND d_year = 1998
          AND ca_state <> s_state
        GROUP BY i_brand_id, i_brand, i_manufact_id, i_manufact
        ORDER BY ext_price DESC, brand_id, i_manufact_id
        LIMIT 100""",
    # catalog window ratio (q20)
    "q20": """
        SELECT i_item_id, i_item_desc, i_category, i_class,
               i_current_price,
               SUM(cs_ext_sales_price) AS itemrevenue,
               SUM(cs_ext_sales_price) * 100.0 /
                 SUM(SUM(cs_ext_sales_price))
                   OVER (PARTITION BY i_class) AS revenueratio
        FROM catalog_sales
        JOIN item ON cs_item_sk = i_item_sk
        JOIN date_dim ON cs_sold_date_sk = d_date_sk
        WHERE i_category IN ('Jewelry', 'Shoes', 'Electronics')
          AND d_year = 1999 AND d_moy BETWEEN 2 AND 3
        GROUP BY i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        ORDER BY i_category, i_class, i_item_id, i_item_desc,
                 revenueratio
        LIMIT 100""",
    # inventory before/after CASE pivot (q21 shape)
    "q21": """
        SELECT w_warehouse_name, i_item_id,
               SUM(CASE WHEN d_moy < 6 THEN inv_quantity_on_hand
                        ELSE 0 END) AS inv_before,
               SUM(CASE WHEN d_moy >= 6 THEN inv_quantity_on_hand
                        ELSE 0 END) AS inv_after
        FROM inventory
        JOIN warehouse ON inv_warehouse_sk = w_warehouse_sk
        JOIN item ON inv_item_sk = i_item_sk
        JOIN date_dim ON inv_date_sk = d_date_sk
        WHERE i_current_price BETWEEN 0.99 AND 50.49
          AND d_year = 1999
        GROUP BY w_warehouse_name, i_item_id
        HAVING SUM(CASE WHEN d_moy >= 6 THEN inv_quantity_on_hand
                        ELSE 0 END) > 0
        ORDER BY w_warehouse_name, i_item_id
        LIMIT 100""",
    # sales + returns chain (q25 shape: ss -> sr by ticket+item)
    "q25": """
        SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
               SUM(ss_net_profit) AS store_sales_profit,
               SUM(sr_net_loss) AS store_returns_loss
        FROM store_sales
        JOIN store_returns ON ss_ticket_number = sr_ticket_number
                          AND ss_item_sk = sr_item_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN store ON ss_store_sk = s_store_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE d_moy = 4 AND d_year = 1999
        GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
        ORDER BY i_item_id, i_item_desc, s_store_id, s_store_name
        LIMIT 100""",
    # demographics-filtered catalog aggregates (q26)
    "q26": """
        SELECT i_item_id,
               AVG(cs_quantity) AS agg1, AVG(cs_list_price) AS agg2,
               AVG(cs_sales_price) AS agg4
        FROM catalog_sales
        JOIN customer_demographics ON cs_bill_customer_sk = cd_demo_sk
        JOIN date_dim ON cs_sold_date_sk = d_date_sk
        JOIN item ON cs_item_sk = i_item_sk
        WHERE cd_gender = 'F' AND cd_marital_status = 'W'
          AND cd_education_status = 'Primary' AND d_year = 1998
        GROUP BY i_item_id
        ORDER BY i_item_id
        LIMIT 100""",
    # inventory availability window (q37 shape)
    "q37": """
        SELECT i_item_id, i_item_desc, i_current_price
        FROM item
        JOIN inventory ON inv_item_sk = i_item_sk
        JOIN date_dim ON d_date_sk = inv_date_sk
        WHERE i_current_price BETWEEN 20.0 AND 50.0
          AND inv_quantity_on_hand BETWEEN 100 AND 500
          AND i_manufact_id IN (3, 8, 17, 19)
          AND d_year = 1999
        GROUP BY i_item_id, i_item_desc, i_current_price
        ORDER BY i_item_id
        LIMIT 100""",
    # catalog sales +/- returns-style CASE by warehouse (q40 shape)
    "q40": """
        SELECT w_state, i_item_id,
               SUM(CASE WHEN d_moy < 6 THEN cs_sales_price
                        ELSE 0.0 END) AS sales_before,
               SUM(CASE WHEN d_moy >= 6 THEN cs_sales_price
                        ELSE 0.0 END) AS sales_after
        FROM catalog_sales
        JOIN warehouse ON cs_warehouse_sk = w_warehouse_sk
        JOIN item ON cs_item_sk = i_item_sk
        JOIN date_dim ON cs_sold_date_sk = d_date_sk
        WHERE i_current_price BETWEEN 0.99 AND 1.49 OR d_year = 1999
        GROUP BY w_state, i_item_id
        ORDER BY w_state, i_item_id
        LIMIT 100""",
    # single-month category revenue (q42)
    "q42": """
        SELECT d_year, i_category_id, i_category,
               SUM(ss_ext_sales_price) AS total_sales
        FROM date_dim
        JOIN store_sales ON d_date_sk = ss_sold_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE d_moy = 12 AND d_year = 1998
        GROUP BY d_year, i_category_id, i_category
        ORDER BY total_sales DESC, d_year, i_category_id, i_category
        LIMIT 100""",
    # day-of-week pivot per store (q43)
    "q43": """
        SELECT s_store_name, s_store_id,
               SUM(CASE WHEN d_day_name = 'Sunday'
                        THEN ss_sales_price ELSE 0.0 END) AS sun_sales,
               SUM(CASE WHEN d_day_name = 'Monday'
                        THEN ss_sales_price ELSE 0.0 END) AS mon_sales,
               SUM(CASE WHEN d_day_name = 'Friday'
                        THEN ss_sales_price ELSE 0.0 END) AS fri_sales,
               SUM(CASE WHEN d_day_name = 'Saturday'
                        THEN ss_sales_price ELSE 0.0 END) AS sat_sales
        FROM date_dim
        JOIN store_sales ON d_date_sk = ss_sold_date_sk
        JOIN store ON ss_store_sk = s_store_sk
        WHERE s_gmt_offset = -5.0 AND d_year = 1998
        GROUP BY s_store_name, s_store_id
        ORDER BY s_store_name, s_store_id
        LIMIT 100""",
    # demographic buckets with CASE counts (q48 shape)
    "q48": """
        SELECT SUM(ss_quantity) AS total_quantity
        FROM store_sales
        JOIN store ON s_store_sk = ss_store_sk
        JOIN customer_demographics ON cd_demo_sk = ss_cdemo_sk
        JOIN customer_address ON ss_addr_sk = ca_address_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE d_year = 1999
          AND ((cd_marital_status = 'M'
                AND cd_education_status = '4 yr Degree'
                AND ss_sales_price BETWEEN 100.0 AND 150.0)
            OR (cd_marital_status = 'D'
                AND cd_education_status = '2 yr Degree'
                AND ss_sales_price BETWEEN 50.0 AND 100.0)
            OR (cd_marital_status = 'S'
                AND cd_education_status = 'College'
                AND ss_sales_price BETWEEN 150.0 AND 200.0))""",
    # brand revenue slice (q52)
    "q52": """
        SELECT d_year, i_brand_id AS brand_id, i_brand AS brand,
               SUM(ss_ext_sales_price) AS ext_price
        FROM date_dim
        JOIN store_sales ON d_date_sk = ss_sold_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE i_manager_id = 1 AND d_moy = 11 AND d_year = 1999
        GROUP BY d_year, i_brand_id, i_brand
        ORDER BY d_year, ext_price DESC, brand_id
        LIMIT 100""",
    # manager slice (q55)
    "q55": """
        SELECT i_brand_id AS brand_id, i_brand AS brand,
               SUM(ss_ext_sales_price) AS ext_price
        FROM date_dim
        JOIN store_sales ON d_date_sk = ss_sold_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE i_manager_id = 4 AND d_moy = 11 AND d_year = 1999
        GROUP BY i_brand_id, i_brand
        ORDER BY ext_price DESC, brand_id
        LIMIT 100""",
    # ship-lag CASE buckets (q62 shape)
    "q62": """
        SELECT w_warehouse_name,
               SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk <= 30
                        THEN 1 ELSE 0 END) AS d30,
               SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 30
                         AND cs_ship_date_sk - cs_sold_date_sk <= 60
                        THEN 1 ELSE 0 END) AS d60,
               SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 60
                        THEN 1 ELSE 0 END) AS dmore
        FROM catalog_sales
        JOIN warehouse ON cs_warehouse_sk = w_warehouse_sk
        JOIN date_dim ON cs_ship_date_sk = d_date_sk
        WHERE d_year = 1999
        GROUP BY w_warehouse_name
        ORDER BY w_warehouse_name
        LIMIT 100""",
    # customer ticket rollup then top-by-window (q68 family shape)
    "q68": """
        SELECT c_last_name, c_first_name, ca_city, bought_city,
               ss_ticket_number, extended_price, extended_tax,
               list_price
        FROM (SELECT ss_ticket_number, ss_customer_sk,
                     ca_city AS bought_city,
                     SUM(ss_ext_sales_price) AS extended_price,
                     SUM(ss_ext_list_price) AS list_price,
                     SUM(ss_ext_tax) AS extended_tax
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
              JOIN customer_address ON ss_addr_sk = ca_address_sk
              WHERE d_dom BETWEEN 1 AND 2
                AND (hd_dep_count = 4 OR hd_vehicle_count = 3)
                AND d_year = 1999
                AND s_city IN ('city1', 'city2')
              GROUP BY ss_ticket_number, ss_customer_sk, ca_city) dn
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        WHERE ca_city <> bought_city
        ORDER BY c_last_name, ss_ticket_number
        LIMIT 100""",
    # store/demographic hour-style counts (q79 shape)
    "q79": """
        SELECT c_last_name, c_first_name,
               SUBSTRING(s_city, 1, 30) AS city_part,
               ss_ticket_number, amt, profit
        FROM (SELECT ss_ticket_number, ss_customer_sk, s_city,
                     SUM(ss_coupon_amt) AS amt,
                     SUM(ss_net_profit) AS profit
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
              WHERE (hd_dep_count = 6 OR hd_vehicle_count > 2)
                AND d_dow = 1 AND d_year = 1998
                AND s_number_employees BETWEEN 200 AND 295
              GROUP BY ss_ticket_number, ss_customer_sk, s_city) ms
        JOIN customer ON ss_customer_sk = c_customer_sk
        ORDER BY c_last_name, c_first_name, city_part, profit
        LIMIT 100""",
    # inventory window by item price band (q82 = q37 over store)
    "q82": """
        SELECT i_item_id, i_item_desc, i_current_price
        FROM item
        JOIN inventory ON inv_item_sk = i_item_sk
        JOIN date_dim ON d_date_sk = inv_date_sk
        JOIN store_sales ON ss_item_sk = i_item_sk
        WHERE i_current_price BETWEEN 30.0 AND 60.0
          AND inv_quantity_on_hand BETWEEN 100 AND 500
          AND i_manufact_id IN (2, 6, 12, 17)
        GROUP BY i_item_id, i_item_desc, i_current_price
        ORDER BY i_item_id
        LIMIT 100""",
    # half-hour-style count over hdemo/store slice (q96 shape)
    "q96": """
        SELECT COUNT(*) AS cnt
        FROM store_sales
        JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
        JOIN store ON ss_store_sk = s_store_sk
        WHERE hd_dep_count = 3 AND s_store_name = 'store7'""",
    # window ratio over store channel (q98)
    "q98": """
        SELECT i_item_id, i_item_desc, i_category, i_class,
               i_current_price,
               SUM(ss_ext_sales_price) AS itemrevenue,
               SUM(ss_ext_sales_price) * 100.0 /
                 SUM(SUM(ss_ext_sales_price))
                   OVER (PARTITION BY i_class) AS revenueratio
        FROM store_sales
        JOIN item ON ss_item_sk = i_item_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE i_category IN ('Men', 'Music', 'Women')
          AND d_year = 1998 AND d_moy BETWEEN 5 AND 6
        GROUP BY i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        ORDER BY i_category, i_class, i_item_id, i_item_desc,
                 revenueratio
        LIMIT 100""",
    # ship-lag buckets, web channel (q99 = q62 over ws) -> by month
    "q99": """
        SELECT d_moy,
               SUM(CASE WHEN ws_quantity < 40 THEN 1 ELSE 0 END)
                 AS small_q,
               SUM(CASE WHEN ws_quantity BETWEEN 40 AND 70
                        THEN 1 ELSE 0 END) AS mid_q,
               SUM(CASE WHEN ws_quantity > 70 THEN 1 ELSE 0 END)
                 AS big_q
        FROM web_sales
        JOIN date_dim ON ws_sold_date_sk = d_date_sk
        WHERE d_year = 1999
        GROUP BY d_moy
        ORDER BY d_moy""",
    # CTE + correlated scalar: customers returning >1.2x the store avg
    "q1": """
        WITH customer_total_return AS (
            SELECT sr_customer_sk AS ctr_customer_sk,
                   sr_store_sk AS ctr_store_sk,
                   SUM(sr_return_amt) AS ctr_total_return
            FROM store_returns
            JOIN date_dim ON sr_returned_date_sk = d_date_sk
            WHERE d_year = 1998
            GROUP BY sr_customer_sk, sr_store_sk)
        SELECT c_customer_id
        FROM customer_total_return ctr1
        JOIN store ON s_store_sk = ctr1.ctr_store_sk
        JOIN customer ON ctr1.ctr_customer_sk = c_customer_sk
        WHERE ctr1.ctr_total_return >
              (SELECT AVG(ctr_total_return) * 1.2
               FROM customer_total_return ctr2
               WHERE ctr1.ctr_store_sk = ctr2.ctr_store_sk)
          AND s_state = 'TN'
        ORDER BY c_customer_id
        LIMIT 100""",
    # union of channels, weekly sums, year-over-year self-join (q2)
    "q2": """
        WITH wscs AS (
            SELECT cs_sold_date_sk AS sold_date_sk,
                   cs_ext_sales_price AS sales_price
            FROM catalog_sales
            UNION ALL
            SELECT ws_sold_date_sk AS sold_date_sk,
                   ws_ext_sales_price AS sales_price
            FROM web_sales),
        wswscs AS (
            SELECT d_week_seq,
                   SUM(CASE WHEN d_day_name = 'Sunday'
                            THEN sales_price ELSE NULL END) AS sun_sales,
                   SUM(CASE WHEN d_day_name = 'Monday'
                            THEN sales_price ELSE NULL END) AS mon_sales,
                   SUM(CASE WHEN d_day_name = 'Friday'
                            THEN sales_price ELSE NULL END) AS fri_sales
            FROM wscs
            JOIN date_dim ON d_date_sk = sold_date_sk
            GROUP BY d_week_seq)
        SELECT y.d_week_seq AS d_week_seq1,
               ROUND(y.sun_sales / z.sun_sales, 2) AS r1,
               ROUND(y.mon_sales / z.mon_sales, 2) AS r2
        FROM wswscs y
        JOIN wswscs z ON y.d_week_seq = z.d_week_seq - 52
        ORDER BY d_week_seq1
        LIMIT 100""",
    # correlated scalar avg by category + month subquery (q6)
    "q6": """
        SELECT a.ca_state AS state, COUNT(*) AS cnt
        FROM customer_address a
        JOIN customer c ON a.ca_address_sk = c.c_current_addr_sk
        JOIN store_sales s ON c.c_customer_sk = s.ss_customer_sk
        JOIN date_dim d ON s.ss_sold_date_sk = d.d_date_sk
        JOIN item i ON s.ss_item_sk = i.i_item_sk
        WHERE d.d_month_seq =
              (SELECT MIN(d_month_seq) FROM date_dim
               WHERE d_year = 1999 AND d_moy = 1)
          AND i.i_current_price > 1.2 *
              (SELECT AVG(j.i_current_price) FROM item j
               WHERE j.i_category = i.i_category)
        GROUP BY a.ca_state
        HAVING COUNT(*) >= 10
        ORDER BY cnt, state
        LIMIT 100""",
    # INTERSECT of customer zips with store zips (q8 shape)
    "q8": """
        SELECT s_store_name, SUM(ss_net_profit) AS profit
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN store ON ss_store_sk = s_store_sk
        WHERE d_year = 1998
          AND s_city IN (SELECT ca_city FROM customer_address
                         INTERSECT
                         SELECT s_city FROM store)
        GROUP BY s_store_name
        ORDER BY s_store_name
        LIMIT 100""",
    # CASE over bucketed scalar subqueries (q9 shape)
    "q9": """
        SELECT CASE WHEN (SELECT COUNT(*) FROM store_sales
                          WHERE ss_quantity BETWEEN 1 AND 20) > 1000
                    THEN (SELECT AVG(ss_ext_discount_amt)
                          FROM store_sales
                          WHERE ss_quantity BETWEEN 1 AND 20)
                    ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                          WHERE ss_quantity BETWEEN 1 AND 20)
               END AS bucket1,
               CASE WHEN (SELECT COUNT(*) FROM store_sales
                          WHERE ss_quantity BETWEEN 21 AND 40) > 1000
                    THEN (SELECT AVG(ss_ext_discount_amt)
                          FROM store_sales
                          WHERE ss_quantity BETWEEN 21 AND 40)
                    ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                          WHERE ss_quantity BETWEEN 21 AND 40)
               END AS bucket2
        FROM reason
        WHERE r_reason_sk = 1""",
    # IN + (EXISTS OR EXISTS) + demographics counts (q10 shape)
    "q10": """
        SELECT cd_gender, cd_marital_status, cd_education_status,
               COUNT(*) AS cnt1, cd_purchase_estimate, COUNT(*) AS cnt2
        FROM customer c
        JOIN customer_address ca ON c.c_current_addr_sk = ca.ca_address_sk
        JOIN customer_demographics ON cd_demo_sk = c.c_current_cdemo_sk
        WHERE ca_county IN ('county1', 'county2', 'county3')
          AND c.c_customer_sk IN
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
        LIMIT 100""",
    # year-over-year growth of customer spend, 2 channels (q11 shape)
    "q11": """
        WITH year_total AS (
            SELECT c_customer_id AS customer_id,
                   c_first_name AS customer_first_name,
                   d_year AS dyear,
                   SUM(ss_ext_list_price - ss_ext_discount_amt)
                       AS year_total,
                   's' AS sale_type
            FROM customer
            JOIN store_sales ON c_customer_sk = ss_customer_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, c_first_name, d_year
            UNION ALL
            SELECT c_customer_id AS customer_id,
                   c_first_name AS customer_first_name,
                   d_year AS dyear,
                   SUM(ws_ext_sales_price - ws_ext_discount_amt)
                       AS year_total,
                   'w' AS sale_type
            FROM customer
            JOIN web_sales ON c_customer_sk = ws_bill_customer_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, c_first_name, d_year)
        SELECT t_s_secyear.customer_id,
               t_s_secyear.customer_first_name
        FROM year_total t_s_firstyear
        JOIN year_total t_s_secyear
          ON t_s_secyear.customer_id = t_s_firstyear.customer_id
        JOIN year_total t_w_firstyear
          ON t_s_firstyear.customer_id = t_w_firstyear.customer_id
        JOIN year_total t_w_secyear
          ON t_s_firstyear.customer_id = t_w_secyear.customer_id
        WHERE t_s_firstyear.sale_type = 's'
          AND t_w_firstyear.sale_type = 'w'
          AND t_s_secyear.sale_type = 's'
          AND t_w_secyear.sale_type = 'w'
          AND t_s_firstyear.dyear = 1998
          AND t_s_secyear.dyear = 1999
          AND t_w_firstyear.dyear = 1998
          AND t_w_secyear.dyear = 1999
          AND t_s_firstyear.year_total > 0
          AND t_w_firstyear.year_total > 0
          AND t_w_secyear.year_total / t_w_firstyear.year_total >
              t_s_secyear.year_total / t_s_firstyear.year_total
        ORDER BY t_s_secyear.customer_id,
                 t_s_secyear.customer_first_name
        LIMIT 100""",
    # OR-of-AND demographic/address bands (q13 shape)
    "q13": """
        SELECT AVG(ss_quantity) AS avg_q,
               AVG(ss_ext_sales_price) AS avg_p,
               AVG(ss_ext_wholesale_cost) AS avg_w,
               SUM(ss_ext_wholesale_cost) AS sum_w
        FROM store_sales
        JOIN store ON s_store_sk = ss_store_sk
        JOIN customer_demographics ON cd_demo_sk = ss_cdemo_sk
        JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
        JOIN customer_address ON ss_addr_sk = ca_address_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        WHERE d_year = 1998
          AND ((cd_marital_status = 'M'
                AND cd_education_status = 'College'
                AND ss_sales_price BETWEEN 100.0 AND 150.0
                AND hd_dep_count = 3)
               OR (cd_marital_status = 'S'
                   AND cd_education_status = 'Primary'
                   AND ss_sales_price BETWEEN 50.0 AND 100.0
                   AND hd_dep_count = 1))
          AND ((ca_state IN ('TX', 'OH') AND ss_net_profit
                BETWEEN 100 AND 200)
               OR (ca_state IN ('WA', 'KY') AND ss_net_profit
                   BETWEEN 50 AND 250))""",
    # EXISTS alt-warehouse + NOT EXISTS returns + count distinct (q16)
    "q16": """
        SELECT COUNT(DISTINCT cs_order_number) AS order_count,
               SUM(cs_ext_ship_cost) AS total_shipping_cost,
               SUM(cs_net_profit) AS total_net_profit
        FROM catalog_sales cs1
        JOIN date_dim ON cs1.cs_ship_date_sk = d_date_sk
        JOIN customer_address ON cs1.cs_ship_mode_sk > 0
             AND ca_address_sk = 1
        JOIN call_center ON cs1.cs_call_center_sk = cc_call_center_sk
        WHERE d_year = 1999 AND d_moy BETWEEN 2 AND 4
          AND cc_county = 'county1'
          AND EXISTS (SELECT 1 FROM catalog_sales cs2
                      WHERE cs1.cs_order_number = cs2.cs_order_number
                        AND cs2.cs_warehouse_sk > 1)
          AND NOT EXISTS (SELECT 1 FROM catalog_returns cr1
                          WHERE cs1.cs_order_number =
                                cr1.cr_order_number)
        LIMIT 100""",
    # ss -> sr -> cs chain with stddev/count stats (q17 shape)
    "q17": """
        SELECT i_item_id, i_item_desc, s_state,
               COUNT(ss_quantity) AS store_sales_quantitycount,
               AVG(ss_quantity) AS store_sales_quantityave,
               STDDEV_SAMP(ss_quantity) AS store_sales_quantitystdev,
               COUNT(sr_return_quantity) AS sr_quantitycount,
               AVG(sr_return_quantity) AS sr_quantityave,
               COUNT(cs_quantity) AS catalog_sales_quantitycount,
               AVG(cs_quantity) AS catalog_sales_quantityave
        FROM store_sales
        JOIN store_returns ON ss_customer_sk = sr_customer_sk
             AND ss_item_sk = sr_item_sk
        JOIN catalog_sales ON sr_customer_sk = cs_bill_customer_sk
             AND sr_item_sk = cs_item_sk
        JOIN date_dim d1 ON d1.d_date_sk = ss_sold_date_sk
        JOIN item ON i_item_sk = ss_item_sk
        JOIN store ON s_store_sk = ss_store_sk
        WHERE d1.d_qoy = 1 AND d1.d_year = 1998
        GROUP BY i_item_id, i_item_desc, s_state
        ORDER BY i_item_id, i_item_desc, s_state
        LIMIT 100""",
    # catalog + demographics rollup (q18 shape)
    "q18": """
        SELECT i_item_id, ca_country, ca_state, ca_county,
               AVG(cs_quantity) AS agg1,
               AVG(cs_list_price) AS agg2,
               AVG(cs_sales_price) AS agg3,
               AVG(cs_net_profit) AS agg4
        FROM catalog_sales
        JOIN customer_demographics cd1
          ON cs_bill_customer_sk > 0 AND cd1.cd_demo_sk = 1
        JOIN customer ON cs_bill_customer_sk = c_customer_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        JOIN date_dim ON cs_sold_date_sk = d_date_sk
        JOIN item ON cs_item_sk = i_item_sk
        WHERE d_year = 1998 AND c_birth_month IN (1, 6, 8, 9)
        GROUP BY ROLLUP(i_item_id, ca_country, ca_state, ca_county)
        ORDER BY ca_country NULLS LAST, ca_state NULLS LAST,
                 ca_county NULLS LAST, i_item_id NULLS LAST
        LIMIT 100""",
    # inventory rollup by product hierarchy (q22)
    "q22": """
        SELECT i_item_id, i_item_desc, i_category, i_class,
               AVG(inv_quantity_on_hand) AS qoh
        FROM inventory
        JOIN date_dim ON inv_date_sk = d_date_sk
        JOIN item ON inv_item_sk = i_item_sk
        WHERE d_month_seq BETWEEN 1176 AND 1187
        GROUP BY ROLLUP(i_item_id, i_item_desc, i_category, i_class)
        ORDER BY qoh, i_item_id NULLS LAST, i_item_desc NULLS LAST,
                 i_category NULLS LAST, i_class NULLS LAST
        LIMIT 100""",
    # store sales + demographics rollup (q27 shape)
    "q27": """
        SELECT i_item_id, s_state, GROUPING(s_state) AS g_state,
               AVG(ss_quantity) AS agg1,
               AVG(ss_list_price) AS agg2,
               AVG(ss_coupon_amt) AS agg3,
               AVG(ss_sales_price) AS agg4
        FROM store_sales
        JOIN customer_demographics ON ss_cdemo_sk = cd_demo_sk
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN store ON ss_store_sk = s_store_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE cd_gender = 'F' AND cd_marital_status = 'W'
          AND cd_education_status = 'Primary'
          AND d_year = 1998 AND s_state = 'TN'
        GROUP BY ROLLUP(i_item_id, s_state)
        ORDER BY i_item_id NULLS LAST, s_state NULLS LAST
        LIMIT 100""",
    # six quantity-band averages via FROM subqueries (q28 shape)
    "q28": """
        SELECT b1.b1_lp, b1.b1_cnt, b2.b2_lp, b2.b2_cnt
        FROM (SELECT AVG(ss_list_price) AS b1_lp,
                     COUNT(ss_list_price) AS b1_cnt
              FROM store_sales
              WHERE ss_quantity BETWEEN 0 AND 5
                AND (ss_list_price BETWEEN 10 AND 20
                     OR ss_coupon_amt BETWEEN 0 AND 20)) b1,
             (SELECT AVG(ss_list_price) AS b2_lp,
                     COUNT(ss_list_price) AS b2_cnt
              FROM store_sales
              WHERE ss_quantity BETWEEN 6 AND 10
                AND (ss_list_price BETWEEN 30 AND 40
                     OR ss_coupon_amt BETWEEN 10 AND 30)) b2
        LIMIT 100""",
    # ss -> sr -> cs chain, quantity sums by store (q29 shape)
    "q29": """
        SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
               SUM(ss_quantity) AS store_sales_quantity,
               SUM(sr_return_quantity) AS store_returns_quantity,
               SUM(cs_quantity) AS catalog_sales_quantity
        FROM store_sales
        JOIN store_returns ON ss_customer_sk = sr_customer_sk
             AND ss_item_sk = sr_item_sk
        JOIN catalog_sales ON sr_customer_sk = cs_bill_customer_sk
             AND sr_item_sk = cs_item_sk
        JOIN date_dim d1 ON d1.d_date_sk = ss_sold_date_sk
        JOIN item ON i_item_sk = ss_item_sk
        JOIN store ON s_store_sk = ss_store_sk
        WHERE d1.d_moy = 4 AND d1.d_year = 1998
        GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
        ORDER BY i_item_id, i_item_desc, s_store_id, s_store_name
        LIMIT 100""",
    # CTE + correlated scalar over web returns by state (q30 shape)
    "q30": """
        WITH customer_total_return AS (
            SELECT wr_returning_customer_sk AS ctr_customer_sk,
                   ca_state AS ctr_state,
                   SUM(wr_return_amt) AS ctr_total_return
            FROM web_returns
            JOIN date_dim ON wr_returned_date_sk = d_date_sk
            JOIN customer_address ON wr_returning_customer_sk > 0
                 AND ca_address_sk = wr_web_page_sk
            WHERE d_year = 1999
            GROUP BY wr_returning_customer_sk, ca_state)
        SELECT c_customer_id, c_first_name, c_last_name,
               ctr_total_return
        FROM customer_total_return ctr1
        JOIN customer ON ctr1.ctr_customer_sk = c_customer_sk
        WHERE ctr1.ctr_total_return >
              (SELECT AVG(ctr_total_return) * 1.2
               FROM customer_total_return ctr2
               WHERE ctr1.ctr_state = ctr2.ctr_state)
        ORDER BY c_customer_id, c_first_name, c_last_name,
                 ctr_total_return
        LIMIT 100""",
    # county growth ratios across quarters, ss vs ws CTEs (q31 shape)
    "q31": """
        WITH ss AS (
            SELECT ca_county, d_qoy, d_year,
                   SUM(ss_ext_sales_price) AS store_sales
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN customer_address ON ss_addr_sk = ca_address_sk
            GROUP BY ca_county, d_qoy, d_year),
        ws AS (
            SELECT ca_county, d_qoy, d_year,
                   SUM(ws_ext_sales_price) AS web_sales
            FROM web_sales
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            JOIN customer_address ON ws_bill_customer_sk > 0
                 AND ca_address_sk = ws_web_site_sk
            GROUP BY ca_county, d_qoy, d_year)
        SELECT ss1.ca_county, ss1.d_year,
               ws2.web_sales / ws1.web_sales AS web_q1_q2_increase,
               ss2.store_sales / ss1.store_sales AS store_q1_q2_increase
        FROM ss ss1
        JOIN ss ss2 ON ss1.ca_county = ss2.ca_county
             AND ss1.d_year = ss2.d_year
        JOIN ws ws1 ON ss1.ca_county = ws1.ca_county
             AND ss1.d_year = ws1.d_year
        JOIN ws ws2 ON ws1.ca_county = ws2.ca_county
             AND ws1.d_year = ws2.d_year
        WHERE ss1.d_qoy = 1 AND ss2.d_qoy = 2
          AND ws1.d_qoy = 1 AND ws2.d_qoy = 2
          AND ss1.d_year = 1999 AND ws1.web_sales > 0
          AND ss1.store_sales > 0
        ORDER BY ss1.ca_county, ss1.d_year
        LIMIT 100""",
    # excess discount: correlated scalar 1.3x avg (q32 shape)
    "q32": """
        SELECT SUM(cs1.cs_ext_discount_amt) AS excess_discount_amount
        FROM catalog_sales cs1
        JOIN item ON cs1.cs_item_sk = i_item_sk
        JOIN date_dim ON d_date_sk = cs1.cs_sold_date_sk
        WHERE i_manufact_id = 7
          AND d_year = 1999 AND d_moy BETWEEN 1 AND 4
          AND cs1.cs_ext_discount_amt >
              (SELECT 1.3 * AVG(cs2.cs_ext_discount_amt)
               FROM catalog_sales cs2
               WHERE cs2.cs_item_sk = cs1.cs_item_sk)
        LIMIT 100""",
    # per-channel manufact revenue CTEs + union + group (q33 shape)
    "q33": """
        WITH ss AS (
            SELECT i_manufact_id,
                   SUM(ss_ext_sales_price) AS total_sales
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN item ON ss_item_sk = i_item_sk
            WHERE i_category = 'Electronics'
              AND d_year = 1998 AND d_moy = 5
            GROUP BY i_manufact_id),
        cs AS (
            SELECT i_manufact_id,
                   SUM(cs_ext_sales_price) AS total_sales
            FROM catalog_sales
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            JOIN item ON cs_item_sk = i_item_sk
            WHERE i_category = 'Electronics'
              AND d_year = 1998 AND d_moy = 5
            GROUP BY i_manufact_id),
        ws AS (
            SELECT i_manufact_id,
                   SUM(ws_ext_sales_price) AS total_sales
            FROM web_sales
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            JOIN item ON ws_item_sk = i_item_sk
            WHERE i_category = 'Electronics'
              AND d_year = 1998 AND d_moy = 5
            GROUP BY i_manufact_id)
        SELECT i_manufact_id, SUM(total_sales) AS total_sales
        FROM (SELECT * FROM ss
              UNION ALL SELECT * FROM cs
              UNION ALL SELECT * FROM ws) tmp1
        GROUP BY i_manufact_id
        ORDER BY total_sales, i_manufact_id
        LIMIT 100""",
    # ticket counts 15..20 by household (q34 shape)
    "q34": """
        SELECT c_last_name, c_first_name, ss_ticket_number, cnt
        FROM (SELECT ss_ticket_number, ss_customer_sk,
                     COUNT(*) AS cnt
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              JOIN household_demographics
                ON ss_hdemo_sk = hd_demo_sk
              WHERE (d_dom BETWEEN 1 AND 3 OR d_dom BETWEEN 25 AND 28)
                AND hd_buy_potential IN ('>10000', 'Unknown')
                AND hd_vehicle_count > 0
                AND d_year = 1998
              GROUP BY ss_ticket_number, ss_customer_sk) dn
        JOIN customer ON ss_customer_sk = c_customer_sk
        WHERE cnt BETWEEN 2 AND 20
        ORDER BY c_last_name NULLS LAST, c_first_name NULLS LAST,
                 ss_ticket_number
        LIMIT 100""",
    # q10 variant: IN store + (EXISTS ws OR EXISTS cs), grouped stats
    "q35": """
        SELECT ca_state, cd_gender, cd_marital_status,
               COUNT(*) AS cnt, AVG(cd_dep_count) AS avg_dep,
               MAX(cd_dep_count) AS max_dep, SUM(cd_dep_count) AS sum_dep
        FROM customer c
        JOIN customer_address ca ON c.c_current_addr_sk = ca.ca_address_sk
        JOIN customer_demographics ON cd_demo_sk = c.c_current_cdemo_sk
        WHERE c.c_customer_sk IN
              (SELECT ss_customer_sk FROM store_sales
               JOIN date_dim ON ss_sold_date_sk = d_date_sk
               WHERE d_year = 1999 AND d_qoy < 4)
          AND (EXISTS (SELECT 1 FROM web_sales
                       JOIN date_dim ON ws_sold_date_sk = d_date_sk
                       WHERE ws_bill_customer_sk = c.c_customer_sk
                         AND d_year = 1999 AND d_qoy < 4)
               OR EXISTS (SELECT 1 FROM catalog_sales
                          JOIN date_dim ON cs_sold_date_sk = d_date_sk
                          WHERE cs_bill_customer_sk = c.c_customer_sk
                            AND d_year = 1999 AND d_qoy < 4))
        GROUP BY ca_state, cd_gender, cd_marital_status
        ORDER BY ca_state NULLS LAST, cd_gender, cd_marital_status
        LIMIT 100""",
    # gross-margin hierarchy rollup + rank within grouping (q36 shape)
    "q36": """
        SELECT SUM(ss_net_profit) / SUM(ss_ext_sales_price)
                   AS gross_margin,
               i_category, i_class,
               GROUPING(i_category) + GROUPING(i_class)
                   AS lochierarchy,
               RANK() OVER (
                   PARTITION BY GROUPING(i_category) +
                                GROUPING(i_class),
                                CASE WHEN GROUPING(i_class) = 0
                                     THEN i_category END
                   ORDER BY SUM(ss_net_profit) /
                            SUM(ss_ext_sales_price) ASC)
                   AS rank_within_parent
        FROM store_sales
        JOIN date_dim d1 ON d1.d_date_sk = ss_sold_date_sk
        JOIN item ON i_item_sk = ss_item_sk
        JOIN store ON s_store_sk = ss_store_sk
        WHERE d1.d_year = 1998 AND s_state = 'TN'
        GROUP BY ROLLUP(i_category, i_class)
        ORDER BY lochierarchy DESC, i_category NULLS LAST,
                 rank_within_parent
        LIMIT 100""",
    # 3-channel customer INTERSECT + count (q38 shape)
    "q38": """
        SELECT COUNT(*) AS cnt
        FROM (SELECT c_last_name, c_first_name, d_date
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN customer ON ss_customer_sk = c_customer_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
              INTERSECT
              SELECT c_last_name, c_first_name, d_date
              FROM catalog_sales
              JOIN date_dim ON cs_sold_date_sk = d_date_sk
              JOIN customer ON cs_bill_customer_sk = c_customer_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
              INTERSECT
              SELECT c_last_name, c_first_name, d_date
              FROM web_sales
              JOIN date_dim ON ws_sold_date_sk = d_date_sk
              JOIN customer ON ws_bill_customer_sk = c_customer_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187) hot_cust
        LIMIT 100""",
    # inventory coefficient-of-variation month self-join (q39 shape)
    "q39": """
        WITH inv AS (
            SELECT w_warehouse_sk, d_moy,
                   STDDEV_SAMP(inv_quantity_on_hand) AS stdev,
                   AVG(inv_quantity_on_hand) AS mean
            FROM inventory
            JOIN warehouse ON inv_warehouse_sk = w_warehouse_sk
            JOIN date_dim ON inv_date_sk = d_date_sk
            WHERE d_year = 1999
            GROUP BY w_warehouse_sk, d_moy)
        SELECT inv1.w_warehouse_sk, inv1.d_moy,
               inv1.mean, inv1.stdev / inv1.mean AS cov
        FROM inv inv1
        JOIN inv inv2 ON inv1.w_warehouse_sk = inv2.w_warehouse_sk
        WHERE inv1.d_moy = 1 AND inv2.d_moy = 2
          AND inv1.mean > 0 AND inv1.stdev / inv1.mean > 0.5
        ORDER BY inv1.w_warehouse_sk, inv1.d_moy
        LIMIT 100""",
    # correlated count subquery over item variants (q41 shape)
    "q41": """
        SELECT DISTINCT i_item_desc
        FROM item i1
        WHERE i_manufact_id BETWEEN 7 AND 14
          AND (SELECT COUNT(*) FROM item i2
               WHERE i2.i_manufact = i1.i_manufact
                 AND ((i2.i_category = 'Women'
                       AND i2.i_color IN ('red', 'navy'))
                      OR (i2.i_category = 'Men'
                          AND i2.i_color IN ('black', 'white')))) > 0
        ORDER BY i_item_desc
        LIMIT 100""",
    # best/worst performing items by rank (q44 shape)
    "q44": """
        SELECT asceding.rnk, i1.i_item_desc AS best_performing,
               i2.i_item_desc AS worst_performing
        FROM (SELECT item_sk, rnk
              FROM (SELECT ss_item_sk AS item_sk,
                           RANK() OVER (ORDER BY AVG(ss_net_profit)
                                        ASC) AS rnk
                    FROM store_sales
                    WHERE ss_store_sk = 4
                    GROUP BY ss_item_sk) v1
              WHERE rnk < 11) asceding
        JOIN (SELECT item_sk, rnk
              FROM (SELECT ss_item_sk AS item_sk,
                           RANK() OVER (ORDER BY AVG(ss_net_profit)
                                        DESC) AS rnk
                    FROM store_sales
                    WHERE ss_store_sk = 4
                    GROUP BY ss_item_sk) v2
              WHERE rnk < 11) descending
          ON asceding.rnk = descending.rnk
        JOIN item i1 ON i1.i_item_sk = asceding.item_sk
        JOIN item i2 ON i2.i_item_sk = descending.item_sk
        ORDER BY asceding.rnk
        LIMIT 100""",
    # zip list OR item IN subquery (q45 shape)
    "q45": """
        SELECT ca_zip, ca_city, SUM(ws_sales_price) AS sum_sales
        FROM web_sales
        JOIN customer ON ws_bill_customer_sk = c_customer_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        JOIN date_dim ON ws_sold_date_sk = d_date_sk
        JOIN item ON ws_item_sk = i_item_sk
        WHERE (SUBSTR(ca_zip, 1, 5) IN
                  ('85669', '86197', '88274', '83405', '86475')
               OR i_item_sk IN (SELECT i_item_sk FROM item
                                WHERE i_manufact_id IN (7, 11, 13)))
          AND d_qoy = 2 AND d_year = 1999
        GROUP BY ca_zip, ca_city
        ORDER BY ca_zip, ca_city
        LIMIT 100""",
    # monthly brand sales vs yearly avg + lag/lead window (q47 shape)
    "q47": """
        WITH v1 AS (
            SELECT i_category, i_brand, s_store_name, s_company_name,
                   d_year, d_moy, SUM(ss_sales_price) AS sum_sales,
                   AVG(SUM(ss_sales_price)) OVER
                       (PARTITION BY i_category, i_brand,
                                     s_store_name, s_company_name,
                                     d_year) AS avg_monthly_sales,
                   RANK() OVER
                       (PARTITION BY i_category, i_brand,
                                     s_store_name, s_company_name
                        ORDER BY d_year, d_moy) AS rn
            FROM item
            JOIN store_sales ON ss_item_sk = i_item_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN store ON ss_store_sk = s_store_sk
            WHERE d_year = 1999
            GROUP BY i_category, i_brand, s_store_name,
                     s_company_name, d_year, d_moy),
        v2 AS (
            SELECT v1.i_category, v1.d_year, v1.d_moy,
                   v1.avg_monthly_sales, v1.sum_sales,
                   v1_lag.sum_sales AS psum,
                   v1_lead.sum_sales AS nsum
            FROM v1
            JOIN v1 v1_lag ON v1.i_category = v1_lag.i_category
                 AND v1.i_brand = v1_lag.i_brand
                 AND v1.s_store_name = v1_lag.s_store_name
                 AND v1.rn = v1_lag.rn + 1
            JOIN v1 v1_lead ON v1.i_category = v1_lead.i_category
                 AND v1.i_brand = v1_lead.i_brand
                 AND v1.s_store_name = v1_lead.s_store_name
                 AND v1.rn = v1_lead.rn - 1)
        SELECT *
        FROM v2
        WHERE avg_monthly_sales > 0
          AND ABS(sum_sales - avg_monthly_sales) /
              avg_monthly_sales > 0.1
        ORDER BY sum_sales - avg_monthly_sales, d_moy
        LIMIT 100""",
    # returned within N days day-bucket pivot (q50 shape)
    "q50": """
        SELECT s_store_name, s_county,
               SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk <= 30
                        THEN 1 ELSE 0 END) AS days_30,
               SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 30
                         AND sr_returned_date_sk - ss_sold_date_sk <= 60
                        THEN 1 ELSE 0 END) AS days_31_60,
               SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 60
                        THEN 1 ELSE 0 END) AS days_over_60
        FROM store_sales
        JOIN store_returns ON ss_ticket_number = sr_ticket_number
        JOIN store ON ss_store_sk = s_store_sk
        JOIN date_dim d2 ON sr_returned_date_sk = d2.d_date_sk
        WHERE d2.d_year = 1999 AND d2.d_moy = 8
        GROUP BY s_store_name, s_county
        ORDER BY s_store_name, s_county
        LIMIT 100""",
    # cumulative channel sales full-outer comparison (q51 shape)
    "q51": """
        WITH web_v1 AS (
            SELECT ws_item_sk AS item_sk, d_moy,
                   SUM(SUM(ws_sales_price)) OVER
                       (PARTITION BY ws_item_sk ORDER BY d_moy
                        ROWS BETWEEN UNBOUNDED PRECEDING
                        AND CURRENT ROW) AS cume_sales
            FROM web_sales
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            WHERE d_month_seq BETWEEN 1176 AND 1187
              AND ws_item_sk IS NOT NULL
            GROUP BY ws_item_sk, d_moy),
        store_v1 AS (
            SELECT ss_item_sk AS item_sk, d_moy,
                   SUM(SUM(ss_sales_price)) OVER
                       (PARTITION BY ss_item_sk ORDER BY d_moy
                        ROWS BETWEEN UNBOUNDED PRECEDING
                        AND CURRENT ROW) AS cume_sales
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE d_month_seq BETWEEN 1176 AND 1187
              AND ss_item_sk IS NOT NULL
            GROUP BY ss_item_sk, d_moy)
        SELECT web.item_sk, web.d_moy,
               web.cume_sales AS web_sales,
               store_v1.cume_sales AS store_sales
        FROM web_v1 web
        JOIN store_v1 ON web.item_sk = store_v1.item_sk
             AND web.d_moy = store_v1.d_moy
        WHERE web.cume_sales > store_v1.cume_sales
        ORDER BY web.item_sk, web.d_moy
        LIMIT 100""",
    # manufacturer quarterly sales vs avg window (q53 shape)
    "q53": """
        SELECT manufact_id, sum_sales, avg_quarterly_sales
        FROM (SELECT i_manufact_id AS manufact_id,
                     SUM(ss_sales_price) AS sum_sales,
                     AVG(SUM(ss_sales_price)) OVER
                         (PARTITION BY i_manufact_id)
                         AS avg_quarterly_sales
              FROM item
              JOIN store_sales ON ss_item_sk = i_item_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
                AND i_category IN ('Books', 'Children', 'Electronics')
              GROUP BY i_manufact_id, d_qoy) tmp1
        WHERE CASE WHEN avg_quarterly_sales > 0
                   THEN ABS(sum_sales - avg_quarterly_sales) /
                        avg_quarterly_sales
                   ELSE NULL END > 0.1
        ORDER BY avg_quarterly_sales, sum_sales, manufact_id
        LIMIT 100""",
    # weekly store sales year-over-year ratios (q59 shape)
    "q59": """
        WITH wss AS (
            SELECT d_week_seq, ss_store_sk,
                   SUM(CASE WHEN d_day_name = 'Sunday'
                            THEN ss_sales_price ELSE NULL END)
                       AS sun_sales,
                   SUM(CASE WHEN d_day_name = 'Monday'
                            THEN ss_sales_price ELSE NULL END)
                       AS mon_sales,
                   SUM(CASE WHEN d_day_name = 'Friday'
                            THEN ss_sales_price ELSE NULL END)
                       AS fri_sales
            FROM store_sales
            JOIN date_dim ON d_date_sk = ss_sold_date_sk
            GROUP BY d_week_seq, ss_store_sk)
        SELECT s_store_name1, s_store_id1, d_week_seq1,
               sun_sales1 / sun_sales2 AS sun_ratio,
               mon_sales1 / mon_sales2 AS mon_ratio
        FROM (SELECT s_store_name AS s_store_name1,
                     wss.d_week_seq AS d_week_seq1,
                     s_store_id AS s_store_id1,
                     sun_sales AS sun_sales1,
                     mon_sales AS mon_sales1
              FROM wss
              JOIN store ON ss_store_sk = s_store_sk
              JOIN date_dim d ON d.d_week_seq = wss.d_week_seq
              WHERE d_month_seq BETWEEN 1176 AND 1187) y
        JOIN (SELECT s_store_name AS s_store_name2,
                     wss.d_week_seq AS d_week_seq2,
                     s_store_id AS s_store_id2,
                     sun_sales AS sun_sales2,
                     mon_sales AS mon_sales2
              FROM wss
              JOIN store ON ss_store_sk = s_store_sk
              JOIN date_dim d ON d.d_week_seq = wss.d_week_seq
              WHERE d_month_seq BETWEEN 1188 AND 1199) x
          ON s_store_id1 = s_store_id2
             AND d_week_seq1 = d_week_seq2 - 52
        ORDER BY s_store_name1, s_store_id1, d_week_seq1
        LIMIT 100""",
    # bought-city vs home-city demographic drill (q46 shape)
    "q46": """
        SELECT c_last_name, c_first_name, ca_city, bought_city,
               ss_ticket_number, amt, profit
        FROM (SELECT ss_ticket_number, ss_customer_sk,
                     ca_city AS bought_city,
                     SUM(ss_coupon_amt) AS amt,
                     SUM(ss_net_profit) AS profit
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              JOIN household_demographics
                ON ss_hdemo_sk = hd_demo_sk
              JOIN customer_address ON ss_addr_sk = ca_address_sk
              WHERE (hd_dep_count = 4 OR hd_vehicle_count = 3)
                AND d_dow IN (6, 0) AND d_year = 1999
              GROUP BY ss_ticket_number, ss_customer_sk, ca_city) dn
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN customer_address current_addr
          ON c_current_addr_sk = current_addr.ca_address_sk
        WHERE current_addr.ca_city <> bought_city
        ORDER BY c_last_name NULLS LAST, c_first_name NULLS LAST,
                 ca_city, bought_city, ss_ticket_number
        LIMIT 100""",
    # 3-channel category CTEs union (q56/q60 shape, by item id)
    "q56": """
        WITH ss AS (
            SELECT i_item_id, SUM(ss_ext_sales_price) AS total_sales
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN customer_address ON ss_addr_sk = ca_address_sk
            JOIN item ON ss_item_sk = i_item_sk
            WHERE i_color IN ('red', 'navy', 'plum')
              AND d_year = 1999 AND d_moy = 2 AND ca_gmt_offset = -5.0
            GROUP BY i_item_id),
        cs AS (
            SELECT i_item_id, SUM(cs_ext_sales_price) AS total_sales
            FROM catalog_sales
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            JOIN item ON cs_item_sk = i_item_sk
            WHERE i_color IN ('red', 'navy', 'plum')
              AND d_year = 1999 AND d_moy = 2
            GROUP BY i_item_id),
        ws AS (
            SELECT i_item_id, SUM(ws_ext_sales_price) AS total_sales
            FROM web_sales
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            JOIN item ON ws_item_sk = i_item_sk
            WHERE i_color IN ('red', 'navy', 'plum')
              AND d_year = 1999 AND d_moy = 2
            GROUP BY i_item_id)
        SELECT i_item_id, SUM(total_sales) AS total_sales
        FROM (SELECT * FROM ss
              UNION ALL SELECT * FROM cs
              UNION ALL SELECT * FROM ws) tmp1
        GROUP BY i_item_id
        ORDER BY total_sales, i_item_id
        LIMIT 100""",
    # catalog monthly brand sales vs avg + neighbors (q57 shape)
    "q57": """
        WITH v1 AS (
            SELECT i_category, i_brand, cc_name, d_year, d_moy,
                   SUM(cs_sales_price) AS sum_sales,
                   AVG(SUM(cs_sales_price)) OVER
                       (PARTITION BY i_category, i_brand, cc_name,
                                     d_year) AS avg_monthly_sales,
                   RANK() OVER
                       (PARTITION BY i_category, i_brand, cc_name
                        ORDER BY d_year, d_moy) AS rn
            FROM item
            JOIN catalog_sales ON cs_item_sk = i_item_sk
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            JOIN call_center ON cc_call_center_sk = cs_call_center_sk
            WHERE d_year = 1999
            GROUP BY i_category, i_brand, cc_name, d_year, d_moy)
        SELECT v1.i_category, v1.d_year, v1.d_moy,
               v1.avg_monthly_sales, v1.sum_sales
        FROM v1
        WHERE v1.avg_monthly_sales > 0
          AND ABS(v1.sum_sales - v1.avg_monthly_sales) /
              v1.avg_monthly_sales > 0.1
        ORDER BY v1.sum_sales - v1.avg_monthly_sales, v1.i_category,
                 v1.d_year, v1.d_moy
        LIMIT 100""",
    # promo vs total sales ratio via two FROM subqueries (q61 shape)
    "q61": """
        SELECT promotions, total,
               promotions / total * 100 AS pct
        FROM (SELECT SUM(ss_ext_sales_price) AS promotions
              FROM store_sales
              JOIN store ON ss_store_sk = s_store_sk
              JOIN promotion ON ss_promo_sk = p_promo_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              WHERE (p_channel_dmail = 'Y' OR p_channel_email = 'Y'
                     OR p_channel_tv = 'Y')
                AND d_year = 1998 AND d_moy = 11) promotional_sales,
             (SELECT SUM(ss_ext_sales_price) AS total
              FROM store_sales
              JOIN store ON ss_store_sk = s_store_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              WHERE d_year = 1998 AND d_moy = 11) all_sales
        ORDER BY promotions, total
        LIMIT 100""",
    # store revenue vs 10% of average per store (q65 shape)
    "q65": """
        SELECT s_store_name, i_item_desc, sc.revenue
        FROM store
        JOIN (SELECT ss_store_sk, AVG(revenue) AS ave
              FROM (SELECT ss_store_sk, ss_item_sk,
                           SUM(ss_sales_price) AS revenue
                    FROM store_sales
                    JOIN date_dim ON ss_sold_date_sk = d_date_sk
                    WHERE d_month_seq BETWEEN 1176 AND 1187
                    GROUP BY ss_store_sk, ss_item_sk) sa
              GROUP BY ss_store_sk) sb
          ON s_store_sk = sb.ss_store_sk
        JOIN (SELECT ss_store_sk, ss_item_sk,
                     SUM(ss_sales_price) AS revenue
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
              GROUP BY ss_store_sk, ss_item_sk) sc
          ON sb.ss_store_sk = sc.ss_store_sk
        JOIN item ON i_item_sk = sc.ss_item_sk
        WHERE sc.revenue <= 0.1 * sb.ave
        ORDER BY s_store_name, i_item_desc
        LIMIT 100""",
    # demographics + EXISTS store AND NOT EXISTS ws/cs (q69 shape)
    "q69": """
        SELECT cd_gender, cd_marital_status, cd_education_status,
               COUNT(*) AS cnt1, cd_purchase_estimate
        FROM customer c
        JOIN customer_address ca
          ON c.c_current_addr_sk = ca.ca_address_sk
        JOIN customer_demographics
          ON cd_demo_sk = c.c_current_cdemo_sk
        WHERE ca_state IN ('KY', 'GA', 'NM', 'TX')
          AND EXISTS (SELECT 1 FROM store_sales
                      JOIN date_dim ON ss_sold_date_sk = d_date_sk
                      WHERE c.c_customer_sk = ss_customer_sk
                        AND d_year = 1999 AND d_moy BETWEEN 1 AND 3)
          AND NOT EXISTS (SELECT 1 FROM web_sales
                          JOIN date_dim
                            ON ws_sold_date_sk = d_date_sk
                          WHERE c.c_customer_sk = ws_bill_customer_sk
                            AND d_year = 1999
                            AND d_moy BETWEEN 1 AND 3)
        GROUP BY cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate
        ORDER BY cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate
        LIMIT 100""",
    # state profit rollup gated by top-5-state subquery (q70 shape)
    "q70": """
        SELECT SUM(ss_net_profit) AS total_sum, s_state, s_county,
               GROUPING(s_state) + GROUPING(s_county) AS lochierarchy
        FROM store_sales
        JOIN date_dim d1 ON d1.d_date_sk = ss_sold_date_sk
        JOIN store ON s_store_sk = ss_store_sk
        WHERE d1.d_month_seq BETWEEN 1176 AND 1187
          AND s_state IN
              (SELECT s_state
               FROM (SELECT s_state,
                            RANK() OVER (PARTITION BY s_state
                                         ORDER BY SUM(ss_net_profit)
                                         DESC) AS ranking
                     FROM store_sales
                     JOIN store ON ss_store_sk = s_store_sk
                     JOIN date_dim ON d_date_sk = ss_sold_date_sk
                     WHERE d_month_seq BETWEEN 1176 AND 1187
                     GROUP BY s_state) tmp1
               WHERE ranking <= 5)
        GROUP BY ROLLUP(s_state, s_county)
        ORDER BY lochierarchy DESC, s_state NULLS LAST,
                 s_county NULLS LAST
        LIMIT 100""",
    # brand revenue by meal time across 3 channels (q71 shape)
    "q71": """
        SELECT i_brand_id AS brand_id, i_brand AS brand, t_hour,
               SUM(ext_price) AS ext_price
        FROM item
        JOIN (SELECT ws_ext_sales_price AS ext_price,
                     ws_sold_date_sk AS sold_date_sk,
                     ws_item_sk AS sold_item_sk,
                     ws_sold_time_sk AS time_sk
              FROM web_sales
              UNION ALL
              SELECT ss_ext_sales_price AS ext_price,
                     ss_sold_date_sk AS sold_date_sk,
                     ss_item_sk AS sold_item_sk,
                     ss_sold_time_sk AS time_sk
              FROM store_sales) tmp
          ON sold_item_sk = i_item_sk
        JOIN date_dim ON d_date_sk = sold_date_sk
        JOIN time_dim ON t_time_sk = time_sk
        WHERE i_manager_id = 1 AND d_moy = 11 AND d_year = 1999
          AND (t_meal_time = 'breakfast' OR t_meal_time = 'dinner')
        GROUP BY i_brand_id, i_brand, t_hour
        ORDER BY ext_price DESC, brand_id, t_hour
        LIMIT 100""",
    # catalog-inventory shortage with promotions (q72 shape)
    "q72": """
        SELECT i_item_desc, w_warehouse_name, d1.d_moy,
               COUNT(*) AS no_promo_or_promo
        FROM catalog_sales
        JOIN inventory ON cs_item_sk = inv_item_sk
        JOIN warehouse ON w_warehouse_sk = inv_warehouse_sk
        JOIN item ON i_item_sk = cs_item_sk
        JOIN household_demographics
          ON cs_bill_customer_sk > 0 AND hd_demo_sk = 1
        JOIN date_dim d1 ON cs_sold_date_sk = d1.d_date_sk
        JOIN date_dim d2 ON inv_date_sk = d2.d_date_sk
             AND d1.d_moy = d2.d_moy
        WHERE d1.d_year = 1999
          AND inv_quantity_on_hand < cs_quantity * 10
        GROUP BY i_item_desc, w_warehouse_name, d1.d_moy
        ORDER BY no_promo_or_promo DESC, i_item_desc,
                 w_warehouse_name, d1.d_moy
        LIMIT 100""",
    # basket counts 1..5 by household (q73 shape)
    "q73": """
        SELECT c_last_name, c_first_name, ss_ticket_number, cnt
        FROM (SELECT ss_ticket_number, ss_customer_sk,
                     COUNT(*) AS cnt
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              JOIN household_demographics
                ON ss_hdemo_sk = hd_demo_sk
              WHERE d_dom BETWEEN 1 AND 2
                AND hd_buy_potential IN ('>10000', '0-500')
                AND hd_vehicle_count > 0 AND d_year = 1999
              GROUP BY ss_ticket_number, ss_customer_sk) dj
        JOIN customer ON ss_customer_sk = c_customer_sk
        WHERE cnt BETWEEN 1 AND 5
        ORDER BY cnt DESC, c_last_name ASC NULLS LAST,
                 c_first_name ASC NULLS LAST, ss_ticket_number
        LIMIT 100""",
    # channel counts over null-extended union (q76 shape)
    "q76": """
        SELECT channel, col_name, d_year, d_qoy, i_category,
               COUNT(*) AS sales_cnt,
               SUM(ext_sales_price) AS sales_amt
        FROM (SELECT 'store' AS channel,
                     'ss_customer_sk' AS col_name, d_year, d_qoy,
                     i_category, ss_ext_sales_price AS ext_sales_price
              FROM store_sales
              JOIN item ON ss_item_sk = i_item_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              WHERE ss_customer_sk IS NULL
              UNION ALL
              SELECT 'web' AS channel,
                     'ws_bill_customer_sk' AS col_name, d_year, d_qoy,
                     i_category, ws_ext_sales_price AS ext_sales_price
              FROM web_sales
              JOIN item ON ws_item_sk = i_item_sk
              JOIN date_dim ON ws_sold_date_sk = d_date_sk
              WHERE ws_bill_customer_sk IS NULL
              UNION ALL
              SELECT 'catalog' AS channel,
                     'cs_bill_customer_sk' AS col_name, d_year, d_qoy,
                     i_category, cs_ext_sales_price AS ext_sales_price
              FROM catalog_sales
              JOIN item ON cs_item_sk = i_item_sk
              JOIN date_dim ON cs_sold_date_sk = d_date_sk
              WHERE cs_bill_customer_sk IS NULL) foo
        GROUP BY channel, col_name, d_year, d_qoy, i_category
        ORDER BY channel, col_name, d_year, d_qoy, i_category
        LIMIT 100""",
    # sales minus returns per channel + rollup (q77 shape)
    "q77": """
        WITH ss AS (
            SELECT s_store_sk, SUM(ss_ext_sales_price) AS sales,
                   SUM(ss_net_profit) AS profit
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN store ON ss_store_sk = s_store_sk
            WHERE d_year = 1999 AND d_moy BETWEEN 6 AND 7
            GROUP BY s_store_sk),
        sr AS (
            SELECT s_store_sk, SUM(sr_return_amt) AS returns_,
                   SUM(sr_net_loss) AS profit_loss
            FROM store_returns
            JOIN date_dim ON sr_returned_date_sk = d_date_sk
            JOIN store ON sr_store_sk = s_store_sk
            WHERE d_year = 1999 AND d_moy BETWEEN 6 AND 7
            GROUP BY s_store_sk)
        SELECT channel, id, SUM(sales) AS sales,
               SUM(returns_) AS returns_, SUM(profit) AS profit
        FROM (SELECT 'store channel' AS channel, ss.s_store_sk AS id,
                     sales, COALESCE(returns_, 0) AS returns_,
                     profit - COALESCE(profit_loss, 0) AS profit
              FROM ss
              LEFT JOIN sr ON ss.s_store_sk = sr.s_store_sk) x
        GROUP BY ROLLUP(channel, id)
        ORDER BY channel NULLS LAST, id NULLS LAST
        LIMIT 100""",
    # sold-minus-returned ratios per channel year (q78 shape)
    "q78": """
        WITH ws AS (
            SELECT d_year AS ws_sold_year, ws_item_sk,
                   ws_bill_customer_sk AS ws_customer_sk,
                   SUM(ws_quantity) AS ws_qty,
                   SUM(ws_wholesale_cost) AS ws_wc,
                   SUM(ws_sales_price) AS ws_sp
            FROM web_sales
            LEFT JOIN web_returns ON wr_order_number = ws_order_number
                 AND ws_item_sk = wr_item_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            WHERE wr_order_number IS NULL
            GROUP BY d_year, ws_item_sk, ws_bill_customer_sk),
        ss AS (
            SELECT d_year AS ss_sold_year, ss_item_sk,
                   ss_customer_sk,
                   SUM(ss_quantity) AS ss_qty,
                   SUM(ss_wholesale_cost) AS ss_wc,
                   SUM(ss_sales_price) AS ss_sp
            FROM store_sales
            LEFT JOIN store_returns
              ON sr_ticket_number = ss_ticket_number
                 AND ss_item_sk = sr_item_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE sr_ticket_number IS NULL
            GROUP BY d_year, ss_item_sk, ss_customer_sk)
        SELECT ss_sold_year, ss_item_sk, ss_customer_sk,
               ROUND(ss_qty / (COALESCE(ws_qty, 0) + 1), 2) AS ratio,
               ss_qty AS store_qty, ss_wc AS store_wholesale_cost
        FROM ss
        LEFT JOIN ws ON ws_sold_year = ss_sold_year
             AND ws_item_sk = ss_item_sk
             AND ws_customer_sk = ss_customer_sk
        WHERE COALESCE(ws_qty, 0) > 0 AND ss_sold_year = 1999
        ORDER BY ss_sold_year, ss_item_sk, ss_customer_sk, ss_qty DESC
        LIMIT 100""",
    # returned items by reason, day-window counts (q85 lite shape)
    "q85": """
        SELECT SUBSTR(r_reason_desc, 1, 20) AS reason,
               AVG(ws_quantity) AS avg_q,
               AVG(wr_refunded_customer_sk) AS avg_ref
        FROM web_sales
        JOIN web_returns ON ws_order_number = wr_order_number
        JOIN web_page ON ws_web_page_sk = wp_web_page_sk
        JOIN reason ON r_reason_sk = wr_reason_sk
        JOIN date_dim ON ws_sold_date_sk = d_date_sk
        WHERE d_year = 1999
          AND (ws_sales_price BETWEEN 100.0 AND 200.0
               OR ws_sales_price BETWEEN 50.0 AND 100.0)
        GROUP BY r_reason_desc
        ORDER BY reason, avg_q, avg_ref
        LIMIT 100""",
    # rollup over web revenue hierarchy (q86 shape)
    "q86": """
        SELECT SUM(ws_net_paid) AS total_sum, i_category, i_class,
               GROUPING(i_category) + GROUPING(i_class)
                   AS lochierarchy
        FROM web_sales
        JOIN date_dim d1 ON d1.d_date_sk = ws_sold_date_sk
        JOIN item ON i_item_sk = ws_item_sk
        WHERE d1.d_month_seq BETWEEN 1176 AND 1187
        GROUP BY ROLLUP(i_category, i_class)
        ORDER BY lochierarchy DESC, i_category NULLS LAST,
                 i_class NULLS LAST
        LIMIT 100""",
    # EXCEPT chain of 3 channels (q87 shape)
    "q87": """
        SELECT COUNT(*) AS cnt
        FROM (SELECT c_last_name, c_first_name, d_date
              FROM store_sales
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN customer ON ss_customer_sk = c_customer_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
              EXCEPT
              SELECT c_last_name, c_first_name, d_date
              FROM catalog_sales
              JOIN date_dim ON cs_sold_date_sk = d_date_sk
              JOIN customer ON cs_bill_customer_sk = c_customer_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
              EXCEPT
              SELECT c_last_name, c_first_name, d_date
              FROM web_sales
              JOIN date_dim ON ws_sold_date_sk = d_date_sk
              JOIN customer ON ws_bill_customer_sk = c_customer_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187) cool_cust""",
    # 3-channel year-over-year customer growth, 6-way CTE self-join
    # (q4)
    "q4": """
        WITH year_total AS (
            SELECT c_customer_id AS customer_id, d_year AS dyear,
                   SUM((ss_ext_list_price - ss_ext_wholesale_cost
                        - ss_ext_discount_amt) / 2) AS year_total,
                   's' AS sale_type
            FROM customer
            JOIN store_sales ON c_customer_sk = ss_customer_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, d_year
            UNION ALL
            SELECT c_customer_id AS customer_id, d_year AS dyear,
                   SUM((cs_ext_list_price - cs_ext_wholesale_cost
                        - cs_ext_discount_amt) / 2) AS year_total,
                   'c' AS sale_type
            FROM customer
            JOIN catalog_sales ON c_customer_sk = cs_bill_customer_sk
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, d_year
            UNION ALL
            SELECT c_customer_id AS customer_id, d_year AS dyear,
                   SUM((ws_ext_sales_price - ws_ext_wholesale_cost
                        - ws_ext_discount_amt) / 2) AS year_total,
                   'w' AS sale_type
            FROM customer
            JOIN web_sales ON c_customer_sk = ws_bill_customer_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, d_year)
        SELECT t_s_secyear.customer_id
        FROM year_total t_s_firstyear
        JOIN year_total t_s_secyear
          ON t_s_secyear.customer_id = t_s_firstyear.customer_id
        JOIN year_total t_c_firstyear
          ON t_s_firstyear.customer_id = t_c_firstyear.customer_id
        JOIN year_total t_c_secyear
          ON t_s_firstyear.customer_id = t_c_secyear.customer_id
        JOIN year_total t_w_firstyear
          ON t_s_firstyear.customer_id = t_w_firstyear.customer_id
        JOIN year_total t_w_secyear
          ON t_s_firstyear.customer_id = t_w_secyear.customer_id
        WHERE t_s_firstyear.sale_type = 's'
          AND t_c_firstyear.sale_type = 'c'
          AND t_w_firstyear.sale_type = 'w'
          AND t_s_secyear.sale_type = 's'
          AND t_c_secyear.sale_type = 'c'
          AND t_w_secyear.sale_type = 'w'
          AND t_s_firstyear.dyear = 1998
          AND t_s_secyear.dyear = 1999
          AND t_c_firstyear.dyear = 1998
          AND t_c_secyear.dyear = 1999
          AND t_w_firstyear.dyear = 1998
          AND t_w_secyear.dyear = 1999
          AND t_s_firstyear.year_total > 0
          AND t_c_firstyear.year_total > 0
          AND t_w_firstyear.year_total > 0
          AND t_c_secyear.year_total / t_c_firstyear.year_total >
              t_s_secyear.year_total / t_s_firstyear.year_total
          AND t_c_secyear.year_total / t_c_firstyear.year_total >
              t_w_secyear.year_total / t_w_firstyear.year_total
        ORDER BY t_s_secyear.customer_id
        LIMIT 100""",
    # per-channel sales+returns union, ROLLUP(channel, id) (q5)
    "q5": """
        WITH ssr AS (
            SELECT s_store_id AS id, SUM(sales_price) AS sales,
                   SUM(return_amt) AS returns_amt,
                   SUM(profit) - SUM(net_loss) AS profit
            FROM (SELECT ss_store_sk AS store_sk,
                         ss_sold_date_sk AS date_sk,
                         ss_ext_sales_price AS sales_price,
                         ss_net_profit AS profit,
                         0.0 AS return_amt, 0.0 AS net_loss
                  FROM store_sales
                  UNION ALL
                  SELECT sr_store_sk AS store_sk,
                         sr_returned_date_sk AS date_sk,
                         0.0 AS sales_price, 0.0 AS profit,
                         sr_return_amt AS return_amt,
                         sr_net_loss AS net_loss
                  FROM store_returns) salesreturns
            JOIN date_dim ON date_sk = d_date_sk
            JOIN store ON store_sk = s_store_sk
            WHERE d_year = 1998 AND d_moy = 8
            GROUP BY s_store_id),
        csr AS (
            SELECT cp_catalog_page_id AS id, SUM(sales_price) AS sales,
                   SUM(return_amt) AS returns_amt,
                   SUM(profit) - SUM(net_loss) AS profit
            FROM (SELECT cs_catalog_page_sk AS page_sk,
                         cs_sold_date_sk AS date_sk,
                         cs_ext_sales_price AS sales_price,
                         cs_net_profit AS profit,
                         0.0 AS return_amt, 0.0 AS net_loss
                  FROM catalog_sales
                  UNION ALL
                  SELECT cr_catalog_page_sk AS page_sk,
                         cr_returned_date_sk AS date_sk,
                         0.0 AS sales_price, 0.0 AS profit,
                         cr_return_amount AS return_amt,
                         cr_net_loss AS net_loss
                  FROM catalog_returns) salesreturns
            JOIN date_dim ON date_sk = d_date_sk
            JOIN catalog_page ON page_sk = cp_catalog_page_sk
            WHERE d_year = 1998 AND d_moy = 8
            GROUP BY cp_catalog_page_id),
        wsr AS (
            SELECT web_site_id AS id, SUM(sales_price) AS sales,
                   SUM(return_amt) AS returns_amt,
                   SUM(profit) - SUM(net_loss) AS profit
            FROM (SELECT ws_web_site_sk AS site_sk,
                         ws_sold_date_sk AS date_sk,
                         ws_ext_sales_price AS sales_price,
                         ws_net_profit AS profit,
                         0.0 AS return_amt, 0.0 AS net_loss
                  FROM web_sales
                  UNION ALL
                  SELECT ws_web_site_sk AS site_sk,
                         wr_returned_date_sk AS date_sk,
                         0.0 AS sales_price, 0.0 AS profit,
                         wr_return_amt AS return_amt,
                         wr_net_loss AS net_loss
                  FROM web_returns
                  JOIN web_sales ON wr_item_sk = ws_item_sk
                       AND wr_order_number = ws_order_number)
                 salesreturns
            JOIN date_dim ON date_sk = d_date_sk
            JOIN web_site ON site_sk = web_site_sk
            WHERE d_year = 1998 AND d_moy = 8
            GROUP BY web_site_id)
        SELECT channel, id, SUM(sales) AS sales,
               SUM(returns_amt) AS returns_amt, SUM(profit) AS profit
        FROM (SELECT 'store channel' AS channel, id, sales,
                     returns_amt, profit
              FROM ssr
              UNION ALL
              SELECT 'catalog channel' AS channel, id, sales,
                     returns_amt, profit
              FROM csr
              UNION ALL
              SELECT 'web channel' AS channel, id, sales,
                     returns_amt, profit
              FROM wsr) x
        GROUP BY ROLLUP (channel, id)
        ORDER BY channel NULLS LAST, id NULLS LAST
        LIMIT 100""",
    # cross-channel INTERSECT of brand/class/category + avg-sales
    # gate + ROLLUP (q14)
    "q14": """
        WITH cross_items AS (
            SELECT i_item_sk AS item_sk
            FROM item
            JOIN (SELECT iss.i_brand_id AS brand_id,
                         iss.i_class_id AS class_id,
                         iss.i_category_id AS category_id
                  FROM store_sales
                  JOIN item iss ON ss_item_sk = iss.i_item_sk
                  JOIN date_dim d1 ON ss_sold_date_sk = d1.d_date_sk
                  WHERE d1.d_year = 1999
                  INTERSECT
                  SELECT ics.i_brand_id AS brand_id,
                         ics.i_class_id AS class_id,
                         ics.i_category_id AS category_id
                  FROM catalog_sales
                  JOIN item ics ON cs_item_sk = ics.i_item_sk
                  JOIN date_dim d2 ON cs_sold_date_sk = d2.d_date_sk
                  WHERE d2.d_year = 1999
                  INTERSECT
                  SELECT iws.i_brand_id AS brand_id,
                         iws.i_class_id AS class_id,
                         iws.i_category_id AS category_id
                  FROM web_sales
                  JOIN item iws ON ws_item_sk = iws.i_item_sk
                  JOIN date_dim d3 ON ws_sold_date_sk = d3.d_date_sk
                  WHERE d3.d_year = 1999) x
              ON i_brand_id = brand_id AND i_class_id = class_id
                 AND i_category_id = category_id),
        avg_sales AS (
            SELECT AVG(quantity * list_price) AS average_sales
            FROM (SELECT ss_quantity AS quantity,
                         ss_list_price AS list_price
                  FROM store_sales
                  JOIN date_dim ON ss_sold_date_sk = d_date_sk
                  WHERE d_year = 1999
                  UNION ALL
                  SELECT cs_quantity AS quantity,
                         cs_list_price AS list_price
                  FROM catalog_sales
                  JOIN date_dim ON cs_sold_date_sk = d_date_sk
                  WHERE d_year = 1999
                  UNION ALL
                  SELECT ws_quantity AS quantity,
                         ws_list_price AS list_price
                  FROM web_sales
                  JOIN date_dim ON ws_sold_date_sk = d_date_sk
                  WHERE d_year = 1999) y)
        SELECT channel, i_brand_id, i_class_id, i_category_id,
               SUM(sales) AS sum_sales, SUM(number_sales) AS num_sales
        FROM (SELECT 'store' AS channel, i_brand_id, i_class_id,
                     i_category_id,
                     SUM(ss_quantity * ss_list_price) AS sales,
                     COUNT(*) AS number_sales
              FROM store_sales
              JOIN item ON ss_item_sk = i_item_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              WHERE ss_item_sk IN (SELECT item_sk FROM cross_items)
                AND d_year = 1999 AND d_moy = 11
              GROUP BY i_brand_id, i_class_id, i_category_id
              UNION ALL
              SELECT 'catalog' AS channel, i_brand_id, i_class_id,
                     i_category_id,
                     SUM(cs_quantity * cs_list_price) AS sales,
                     COUNT(*) AS number_sales
              FROM catalog_sales
              JOIN item ON cs_item_sk = i_item_sk
              JOIN date_dim ON cs_sold_date_sk = d_date_sk
              WHERE cs_item_sk IN (SELECT item_sk FROM cross_items)
                AND d_year = 1999 AND d_moy = 11
              GROUP BY i_brand_id, i_class_id, i_category_id
              UNION ALL
              SELECT 'web' AS channel, i_brand_id, i_class_id,
                     i_category_id,
                     SUM(ws_quantity * ws_list_price) AS sales,
                     COUNT(*) AS number_sales
              FROM web_sales
              JOIN item ON ws_item_sk = i_item_sk
              JOIN date_dim ON ws_sold_date_sk = d_date_sk
              WHERE ws_item_sk IN (SELECT item_sk FROM cross_items)
                AND d_year = 1999 AND d_moy = 11
              GROUP BY i_brand_id, i_class_id, i_category_id) z
        WHERE sales > (SELECT average_sales FROM avg_sales)
        GROUP BY ROLLUP (channel, i_brand_id, i_class_id,
                         i_category_id)
        ORDER BY channel NULLS LAST, i_brand_id NULLS LAST,
                 i_class_id NULLS LAST, i_category_id NULLS LAST
        LIMIT 100""",
    # frequent items + best customers CTEs gating catalog/web sales
    # (q23)
    "q23": """
        WITH frequent_ss_items AS (
            SELECT ss_item_sk AS item_sk
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE d_year = 1998
            GROUP BY ss_item_sk
            HAVING COUNT(*) > 4),
        customer_totals AS (
            SELECT ss_customer_sk AS customer_sk,
                   SUM(ss_quantity * ss_sales_price) AS csales
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE d_year = 1998
            GROUP BY ss_customer_sk),
        best_ss_customer AS (
            SELECT customer_sk
            FROM customer_totals
            WHERE csales > 0.5 *
                  (SELECT MAX(csales) FROM customer_totals))
        SELECT SUM(sales) AS total_catalog_web
        FROM (SELECT cs_quantity * cs_list_price AS sales
              FROM catalog_sales
              JOIN date_dim ON cs_sold_date_sk = d_date_sk
              WHERE d_year = 1998 AND d_moy = 3
                AND cs_item_sk IN
                    (SELECT item_sk FROM frequent_ss_items)
                AND cs_bill_customer_sk IN
                    (SELECT customer_sk FROM best_ss_customer)
              UNION ALL
              SELECT ws_quantity * ws_list_price AS sales
              FROM web_sales
              JOIN date_dim ON ws_sold_date_sk = d_date_sk
              WHERE d_year = 1998 AND d_moy = 3
                AND ws_item_sk IN
                    (SELECT item_sk FROM frequent_ss_items)
                AND ws_bill_customer_sk IN
                    (SELECT customer_sk FROM best_ss_customer)) x""",
    # store-sales net-paid by color vs 5%-of-average gate (q24)
    "q24": """
        WITH ssales AS (
            SELECT c_last_name, c_first_name, s_store_name, i_color,
                   SUM(ss_net_paid) AS netpaid
            FROM store_sales
            JOIN store_returns ON ss_ticket_number = sr_ticket_number
                 AND ss_item_sk = sr_item_sk
            JOIN store ON ss_store_sk = s_store_sk
            JOIN item ON ss_item_sk = i_item_sk
            JOIN customer ON ss_customer_sk = c_customer_sk
            JOIN customer_address ON c_current_addr_sk = ca_address_sk
            WHERE s_state = 'TN' AND ca_state <> s_state
            GROUP BY c_last_name, c_first_name, s_store_name, i_color)
        SELECT c_last_name, c_first_name, s_store_name, paid
        FROM (SELECT c_last_name, c_first_name, s_store_name,
                     SUM(netpaid) AS paid
              FROM ssales
              WHERE i_color = 'plum'
              GROUP BY c_last_name, c_first_name, s_store_name)
             by_store
        WHERE paid > (SELECT 0.05 * AVG(netpaid) FROM ssales)
        ORDER BY c_last_name, c_first_name, s_store_name
        LIMIT 100""",
    # per-channel worst return ratios, dual RANK, union (q49)
    "q49": """
        SELECT channel, item, return_ratio, return_rank,
               currency_rank
        FROM (
            SELECT 'web' AS channel, item, return_ratio, return_rank,
                   currency_rank
            FROM (SELECT item, return_ratio, currency_ratio,
                         RANK() OVER (ORDER BY return_ratio, item)
                             AS return_rank,
                         RANK() OVER (ORDER BY currency_ratio, item)
                             AS currency_rank
                  FROM (SELECT ws_item_sk AS item,
                               SUM(COALESCE(wr_return_quantity, 0)) *
                                   1.0 / SUM(ws_quantity)
                                   AS return_ratio,
                               SUM(COALESCE(wr_return_amt, 0.0)) /
                                   SUM(ws_net_paid) AS currency_ratio
                        FROM web_sales
                        LEFT JOIN web_returns
                          ON ws_order_number = wr_order_number
                             AND ws_item_sk = wr_item_sk
                        JOIN date_dim ON ws_sold_date_sk = d_date_sk
                        WHERE d_year = 1999 AND d_moy = 12
                          AND ws_net_profit > 1
                        GROUP BY ws_item_sk) in_web) w
            WHERE return_rank <= 10 OR currency_rank <= 10
            UNION ALL
            SELECT 'catalog' AS channel, item, return_ratio,
                   return_rank, currency_rank
            FROM (SELECT item, return_ratio, currency_ratio,
                         RANK() OVER (ORDER BY return_ratio, item)
                             AS return_rank,
                         RANK() OVER (ORDER BY currency_ratio, item)
                             AS currency_rank
                  FROM (SELECT cs_item_sk AS item,
                               SUM(COALESCE(cr_return_quantity, 0)) *
                                   1.0 / SUM(cs_quantity)
                                   AS return_ratio,
                               SUM(COALESCE(cr_return_amount, 0.0)) /
                                   SUM(cs_ext_sales_price)
                                   AS currency_ratio
                        FROM catalog_sales
                        LEFT JOIN catalog_returns
                          ON cs_order_number = cr_order_number
                             AND cs_item_sk = cr_item_sk
                        JOIN date_dim ON cs_sold_date_sk = d_date_sk
                        WHERE d_year = 1999 AND d_moy = 12
                          AND cs_net_profit > 1
                        GROUP BY cs_item_sk) in_cat) c
            WHERE return_rank <= 10 OR currency_rank <= 10
            UNION ALL
            SELECT 'store' AS channel, item, return_ratio,
                   return_rank, currency_rank
            FROM (SELECT item, return_ratio, currency_ratio,
                         RANK() OVER (ORDER BY return_ratio, item)
                             AS return_rank,
                         RANK() OVER (ORDER BY currency_ratio, item)
                             AS currency_rank
                  FROM (SELECT ss_item_sk AS item,
                               SUM(COALESCE(sr_return_quantity, 0)) *
                                   1.0 / SUM(ss_quantity)
                                   AS return_ratio,
                               SUM(COALESCE(sr_return_amt, 0.0)) /
                                   SUM(ss_net_paid) AS currency_ratio
                        FROM store_sales
                        LEFT JOIN store_returns
                          ON ss_ticket_number = sr_ticket_number
                             AND ss_item_sk = sr_item_sk
                        JOIN date_dim ON ss_sold_date_sk = d_date_sk
                        WHERE d_year = 1999 AND d_moy = 12
                          AND ss_net_profit > 1
                        GROUP BY ss_item_sk) in_store) s
            WHERE return_rank <= 10 OR currency_rank <= 10) channels
        ORDER BY channel, return_rank, currency_rank, item
        LIMIT 100""",
    # catalog/web buyers' store revenue segmented into $50 bands
    # (q54)
    "q54": """
        WITH my_customers AS (
            SELECT c_customer_sk, c_current_addr_sk
            FROM (SELECT cs_sold_date_sk AS sold_date_sk,
                         cs_bill_customer_sk AS customer_sk,
                         cs_item_sk AS item_sk
                  FROM catalog_sales
                  UNION ALL
                  SELECT ws_sold_date_sk AS sold_date_sk,
                         ws_bill_customer_sk AS customer_sk,
                         ws_item_sk AS item_sk
                  FROM web_sales) cs_or_ws_sales
            JOIN item ON item_sk = i_item_sk
            JOIN date_dim ON sold_date_sk = d_date_sk
            JOIN customer ON c_customer_sk = customer_sk
            WHERE i_category = 'Women' AND i_class = 'class3'
              AND d_year = 1998 AND d_moy = 12
            GROUP BY c_customer_sk, c_current_addr_sk),
        my_revenue AS (
            SELECT c_customer_sk,
                   SUM(ss_ext_sales_price) AS revenue
            FROM my_customers
            JOIN store_sales ON c_customer_sk = ss_customer_sk
            JOIN customer_address
                 ON c_current_addr_sk = ca_address_sk
            JOIN store ON ca_state = s_state
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE d_month_seq BETWEEN 1200 AND 1202
            GROUP BY c_customer_sk)
        SELECT segment, COUNT(*) AS num_customers,
               segment * 50 AS segment_base
        FROM (SELECT CAST(revenue / 50 AS INT) AS segment
              FROM my_revenue) segments
        GROUP BY segment
        ORDER BY segment, num_customers
        LIMIT 100""",
    # same-week item revenue within 10% across 3 channels (q58)
    "q58": """
        WITH ss_items AS (
            SELECT i_item_id AS item_id,
                   SUM(ss_ext_sales_price) AS ss_item_rev
            FROM store_sales
            JOIN item ON ss_item_sk = i_item_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE d_week_seq = 5150
            GROUP BY i_item_id),
        cs_items AS (
            SELECT i_item_id AS item_id,
                   SUM(cs_ext_sales_price) AS cs_item_rev
            FROM catalog_sales
            JOIN item ON cs_item_sk = i_item_sk
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            WHERE d_week_seq = 5150
            GROUP BY i_item_id),
        ws_items AS (
            SELECT i_item_id AS item_id,
                   SUM(ws_ext_sales_price) AS ws_item_rev
            FROM web_sales
            JOIN item ON ws_item_sk = i_item_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            WHERE d_week_seq = 5150
            GROUP BY i_item_id)
        SELECT ss_items.item_id, ss_item_rev, cs_item_rev,
               ws_item_rev,
               (ss_item_rev + cs_item_rev + ws_item_rev) / 3
                   AS average
        FROM ss_items
        JOIN cs_items ON ss_items.item_id = cs_items.item_id
        JOIN ws_items ON ss_items.item_id = ws_items.item_id
        WHERE ss_item_rev >= 0.9 * cs_item_rev
          AND ss_item_rev <= 1.1 * cs_item_rev
          AND ss_item_rev >= 0.9 * ws_item_rev
          AND ss_item_rev <= 1.1 * ws_item_rev
        ORDER BY ss_items.item_id, ss_item_rev
        LIMIT 100""",
    # category revenue by item across 3 channels in one geography
    # (q60)
    "q60": """
        WITH ss_t AS (
            SELECT i_item_id, SUM(ss_ext_sales_price) AS total_sales
            FROM store_sales
            JOIN item ON ss_item_sk = i_item_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN customer_address ON ss_addr_sk = ca_address_sk
            WHERE i_category = 'Music' AND d_year = 1999 AND d_moy = 9
              AND ca_gmt_offset = -5.0
            GROUP BY i_item_id),
        cs_t AS (
            SELECT i_item_id, SUM(cs_ext_sales_price) AS total_sales
            FROM catalog_sales
            JOIN item ON cs_item_sk = i_item_sk
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            JOIN customer ON cs_bill_customer_sk = c_customer_sk
            JOIN customer_address
                 ON c_current_addr_sk = ca_address_sk
            WHERE i_category = 'Music' AND d_year = 1999 AND d_moy = 9
              AND ca_gmt_offset = -5.0
            GROUP BY i_item_id),
        ws_t AS (
            SELECT i_item_id, SUM(ws_ext_sales_price) AS total_sales
            FROM web_sales
            JOIN item ON ws_item_sk = i_item_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            JOIN customer ON ws_bill_customer_sk = c_customer_sk
            JOIN customer_address
                 ON c_current_addr_sk = ca_address_sk
            WHERE i_category = 'Music' AND d_year = 1999 AND d_moy = 9
              AND ca_gmt_offset = -5.0
            GROUP BY i_item_id)
        SELECT i_item_id, SUM(total_sales) AS total_sales
        FROM (SELECT i_item_id, total_sales FROM ss_t
              UNION ALL
              SELECT i_item_id, total_sales FROM cs_t
              UNION ALL
              SELECT i_item_id, total_sales FROM ws_t) x
        GROUP BY i_item_id
        ORDER BY i_item_id, total_sales
        LIMIT 100""",
    # manager monthly sales vs windowed average deviation (q63)
    "q63": """
        SELECT manager_id, sum_sales, avg_monthly_sales
        FROM (SELECT i_manager_id AS manager_id,
                     SUM(ss_sales_price) AS sum_sales,
                     AVG(SUM(ss_sales_price)) OVER
                         (PARTITION BY i_manager_id)
                         AS avg_monthly_sales
              FROM item
              JOIN store_sales ON ss_item_sk = i_item_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              WHERE d_month_seq BETWEEN 1176 AND 1187
                AND ((i_category IN ('Books', 'Children',
                                     'Electronics')
                      AND i_class IN ('class1', 'class2', 'class3'))
                     OR (i_category IN ('Women', 'Music', 'Men')
                         AND i_class IN ('class4', 'class5',
                                         'class6')))
              GROUP BY i_manager_id, d_moy) tmp1
        WHERE CASE WHEN avg_monthly_sales > 0
                   THEN ABS(sum_sales - avg_monthly_sales) /
                        avg_monthly_sales
                   ELSE NULL END > 0.1
        ORDER BY manager_id, avg_monthly_sales, sum_sales
        LIMIT 100""",
    # returned-catalog-item store sales, two-year self-join on
    # item+store (q64)
    "q64": """
        WITH cs_ui AS (
            SELECT cs_item_sk AS u_item_sk
            FROM catalog_sales
            JOIN catalog_returns ON cs_item_sk = cr_item_sk
                 AND cs_order_number = cr_order_number
            GROUP BY cs_item_sk
            HAVING SUM(cs_ext_list_price) >
                   2 * SUM(cr_return_amount)),
        cross_sales AS (
            SELECT i_item_id AS product_name, i_item_sk AS item_sk,
                   s_store_name, s_city, d_year AS syear,
                   COUNT(*) AS cnt,
                   SUM(ss_wholesale_cost) AS s1,
                   SUM(ss_list_price) AS s2,
                   SUM(ss_coupon_amt) AS s3
            FROM store_sales
            JOIN store_returns ON ss_ticket_number = sr_ticket_number
                 AND ss_item_sk = sr_item_sk
            JOIN cs_ui ON ss_item_sk = u_item_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN store ON ss_store_sk = s_store_sk
            JOIN customer ON ss_customer_sk = c_customer_sk
            JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
            JOIN income_band
                 ON hd_income_band_sk = ib_income_band_sk
            JOIN item ON ss_item_sk = i_item_sk
            WHERE i_color IN ('plum', 'navy', 'orchid', 'chiffon')
              AND ib_lower_bound >= 0
            GROUP BY i_item_id, i_item_sk, s_store_name, s_city,
                     d_year)
        SELECT cs1.product_name, cs1.s_store_name, cs1.syear,
               cs1.cnt AS cnt1, cs2.syear AS syear2, cs2.cnt AS cnt2,
               cs1.s1, cs1.s2, cs1.s3,
               cs2.s1 AS s1_2, cs2.s2 AS s2_2, cs2.s3 AS s3_2
        FROM cross_sales cs1
        JOIN cross_sales cs2 ON cs1.item_sk = cs2.item_sk
             AND cs1.s_store_name = cs2.s_store_name
             AND cs1.s_city = cs2.s_city
        WHERE cs1.syear = 1998 AND cs2.syear = 1999
          AND cs2.cnt <= cs1.cnt
        ORDER BY cs1.product_name, cs1.s_store_name, cs2.cnt,
                 cs1.s1, cs2.s1
        LIMIT 100""",
    # warehouse shipping pivot by month, web+catalog union (q66;
    # 6-month pivot of the original's 12)
    "q66": """
        SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_state,
               ship_carriers, year_,
               SUM(m1_sales) AS jan_sales, SUM(m2_sales) AS feb_sales,
               SUM(m3_sales) AS mar_sales, SUM(m4_sales) AS apr_sales,
               SUM(m5_sales) AS may_sales, SUM(m6_sales) AS jun_sales,
               SUM(m1_net) AS jan_net, SUM(m2_net) AS feb_net,
               SUM(m3_net) AS mar_net
        FROM (
            SELECT w_warehouse_name, w_warehouse_sq_ft, w_city,
                   w_state, 'UPS,FEDEX' AS ship_carriers,
                   d_year AS year_,
                   SUM(CASE WHEN d_moy = 1 THEN ws_ext_sales_price *
                       ws_quantity ELSE 0 END) AS m1_sales,
                   SUM(CASE WHEN d_moy = 2 THEN ws_ext_sales_price *
                       ws_quantity ELSE 0 END) AS m2_sales,
                   SUM(CASE WHEN d_moy = 3 THEN ws_ext_sales_price *
                       ws_quantity ELSE 0 END) AS m3_sales,
                   SUM(CASE WHEN d_moy = 4 THEN ws_ext_sales_price *
                       ws_quantity ELSE 0 END) AS m4_sales,
                   SUM(CASE WHEN d_moy = 5 THEN ws_ext_sales_price *
                       ws_quantity ELSE 0 END) AS m5_sales,
                   SUM(CASE WHEN d_moy = 6 THEN ws_ext_sales_price *
                       ws_quantity ELSE 0 END) AS m6_sales,
                   SUM(CASE WHEN d_moy = 1 THEN ws_net_paid *
                       ws_quantity ELSE 0 END) AS m1_net,
                   SUM(CASE WHEN d_moy = 2 THEN ws_net_paid *
                       ws_quantity ELSE 0 END) AS m2_net,
                   SUM(CASE WHEN d_moy = 3 THEN ws_net_paid *
                       ws_quantity ELSE 0 END) AS m3_net
            FROM web_sales
            JOIN warehouse ON ws_warehouse_sk = w_warehouse_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            JOIN time_dim ON ws_sold_time_sk = t_time_sk
            JOIN ship_mode ON ws_ship_mode_sk = sm_ship_mode_sk
            WHERE d_year = 1999 AND t_hour BETWEEN 8 AND 17
              AND sm_carrier IN ('UPS', 'FEDEX')
            GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city,
                     w_state, d_year
            UNION ALL
            SELECT w_warehouse_name, w_warehouse_sq_ft, w_city,
                   w_state, 'UPS,FEDEX' AS ship_carriers,
                   d_year AS year_,
                   SUM(CASE WHEN d_moy = 1 THEN cs_sales_price *
                       cs_quantity ELSE 0 END) AS m1_sales,
                   SUM(CASE WHEN d_moy = 2 THEN cs_sales_price *
                       cs_quantity ELSE 0 END) AS m2_sales,
                   SUM(CASE WHEN d_moy = 3 THEN cs_sales_price *
                       cs_quantity ELSE 0 END) AS m3_sales,
                   SUM(CASE WHEN d_moy = 4 THEN cs_sales_price *
                       cs_quantity ELSE 0 END) AS m4_sales,
                   SUM(CASE WHEN d_moy = 5 THEN cs_sales_price *
                       cs_quantity ELSE 0 END) AS m5_sales,
                   SUM(CASE WHEN d_moy = 6 THEN cs_sales_price *
                       cs_quantity ELSE 0 END) AS m6_sales,
                   SUM(CASE WHEN d_moy = 1 THEN cs_net_profit *
                       cs_quantity ELSE 0 END) AS m1_net,
                   SUM(CASE WHEN d_moy = 2 THEN cs_net_profit *
                       cs_quantity ELSE 0 END) AS m2_net,
                   SUM(CASE WHEN d_moy = 3 THEN cs_net_profit *
                       cs_quantity ELSE 0 END) AS m3_net
            FROM catalog_sales
            JOIN warehouse ON cs_warehouse_sk = w_warehouse_sk
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            JOIN time_dim ON cs_sold_time_sk = t_time_sk
            JOIN ship_mode ON cs_ship_mode_sk = sm_ship_mode_sk
            WHERE d_year = 1999 AND t_hour BETWEEN 8 AND 17
              AND sm_carrier IN ('UPS', 'FEDEX')
            GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city,
                     w_state, d_year) x
        GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city,
                 w_state, ship_carriers, year_
        ORDER BY w_warehouse_name, w_warehouse_sq_ft, w_city,
                 w_state, year_
        LIMIT 100""",
    # 4-level ROLLUP + per-category RANK over sumsales (q67)
    "q67": """
        SELECT i_category, i_class, i_brand, s_store_id, sumsales, rk
        FROM (SELECT i_category, i_class, i_brand, s_store_id,
                     sumsales,
                     RANK() OVER (PARTITION BY i_category
                                  ORDER BY sumsales DESC) AS rk
              FROM (SELECT i_category, i_class, i_brand, s_store_id,
                           SUM(ss_sales_price * ss_quantity)
                               AS sumsales
                    FROM store_sales
                    JOIN date_dim ON ss_sold_date_sk = d_date_sk
                    JOIN store ON ss_store_sk = s_store_sk
                    JOIN item ON ss_item_sk = i_item_sk
                    WHERE d_month_seq BETWEEN 1176 AND 1187
                    GROUP BY ROLLUP (i_category, i_class, i_brand,
                                     s_store_id)) dw1) dw2
        WHERE rk <= 10
        ORDER BY i_category NULLS LAST, i_class NULLS LAST,
                 i_brand NULLS LAST, s_store_id NULLS LAST, rk
        LIMIT 100""",
    # store/web year-over-year net-paid growth (q74)
    "q74": """
        WITH year_total AS (
            SELECT c_customer_id AS customer_id,
                   c_first_name AS customer_first_name,
                   d_year AS dyear,
                   SUM(ss_net_paid) AS year_total, 's' AS sale_type
            FROM customer
            JOIN store_sales ON c_customer_sk = ss_customer_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, c_first_name, d_year
            UNION ALL
            SELECT c_customer_id AS customer_id,
                   c_first_name AS customer_first_name,
                   d_year AS dyear,
                   SUM(ws_net_paid) AS year_total, 'w' AS sale_type
            FROM customer
            JOIN web_sales ON c_customer_sk = ws_bill_customer_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            GROUP BY c_customer_id, c_first_name, d_year)
        SELECT t_s_secyear.customer_id,
               t_s_secyear.customer_first_name
        FROM year_total t_s_firstyear
        JOIN year_total t_s_secyear
          ON t_s_secyear.customer_id = t_s_firstyear.customer_id
        JOIN year_total t_w_firstyear
          ON t_s_firstyear.customer_id = t_w_firstyear.customer_id
        JOIN year_total t_w_secyear
          ON t_s_firstyear.customer_id = t_w_secyear.customer_id
        WHERE t_s_firstyear.sale_type = 's'
          AND t_w_firstyear.sale_type = 'w'
          AND t_s_secyear.sale_type = 's'
          AND t_w_secyear.sale_type = 'w'
          AND t_s_firstyear.dyear = 1998
          AND t_s_secyear.dyear = 1999
          AND t_w_firstyear.dyear = 1998
          AND t_w_secyear.dyear = 1999
          AND t_s_firstyear.year_total > 0
          AND t_w_firstyear.year_total > 0
          AND t_w_secyear.year_total / t_w_firstyear.year_total >
              t_s_secyear.year_total / t_s_firstyear.year_total
        ORDER BY t_s_secyear.customer_id,
                 t_s_secyear.customer_first_name
        LIMIT 100""",
    # net-of-returns sales decline year-over-year, 3 channels (q75)
    "q75": """
        WITH all_sales AS (
            SELECT d_year, i_brand_id, i_class_id, i_category_id,
                   i_manufact_id, SUM(sales_cnt) AS sales_cnt,
                   SUM(sales_amt) AS sales_amt
            FROM (SELECT d_year, i_brand_id, i_class_id,
                         i_category_id, i_manufact_id,
                         cs_quantity -
                             COALESCE(cr_return_quantity, 0)
                             AS sales_cnt,
                         cs_ext_sales_price -
                             COALESCE(cr_return_amount, 0.0)
                             AS sales_amt
                  FROM catalog_sales
                  JOIN item ON cs_item_sk = i_item_sk
                  JOIN date_dim ON cs_sold_date_sk = d_date_sk
                  LEFT JOIN catalog_returns
                    ON cs_order_number = cr_order_number
                       AND cs_item_sk = cr_item_sk
                  WHERE i_category = 'Books'
                  UNION ALL
                  SELECT d_year, i_brand_id, i_class_id,
                         i_category_id, i_manufact_id,
                         ss_quantity -
                             COALESCE(sr_return_quantity, 0)
                             AS sales_cnt,
                         ss_ext_sales_price -
                             COALESCE(sr_return_amt, 0.0)
                             AS sales_amt
                  FROM store_sales
                  JOIN item ON ss_item_sk = i_item_sk
                  JOIN date_dim ON ss_sold_date_sk = d_date_sk
                  LEFT JOIN store_returns
                    ON ss_ticket_number = sr_ticket_number
                       AND ss_item_sk = sr_item_sk
                  WHERE i_category = 'Books'
                  UNION ALL
                  SELECT d_year, i_brand_id, i_class_id,
                         i_category_id, i_manufact_id,
                         ws_quantity -
                             COALESCE(wr_return_quantity, 0)
                             AS sales_cnt,
                         ws_ext_sales_price -
                             COALESCE(wr_return_amt, 0.0)
                             AS sales_amt
                  FROM web_sales
                  JOIN item ON ws_item_sk = i_item_sk
                  JOIN date_dim ON ws_sold_date_sk = d_date_sk
                  LEFT JOIN web_returns
                    ON ws_order_number = wr_order_number
                       AND ws_item_sk = wr_item_sk
                  WHERE i_category = 'Books') sales_detail
            GROUP BY d_year, i_brand_id, i_class_id, i_category_id,
                     i_manufact_id)
        SELECT prev_yr.d_year AS prev_year,
               curr_yr.d_year AS sales_year, curr_yr.i_brand_id,
               curr_yr.i_class_id, curr_yr.i_category_id,
               curr_yr.i_manufact_id,
               prev_yr.sales_cnt AS prev_yr_cnt,
               curr_yr.sales_cnt AS curr_yr_cnt,
               curr_yr.sales_cnt - prev_yr.sales_cnt
                   AS sales_cnt_diff,
               curr_yr.sales_amt - prev_yr.sales_amt
                   AS sales_amt_diff
        FROM all_sales curr_yr
        JOIN all_sales prev_yr
          ON curr_yr.i_brand_id = prev_yr.i_brand_id
             AND curr_yr.i_class_id = prev_yr.i_class_id
             AND curr_yr.i_category_id = prev_yr.i_category_id
             AND curr_yr.i_manufact_id = prev_yr.i_manufact_id
        WHERE curr_yr.d_year = 1999 AND prev_yr.d_year = 1998
          AND 1.0 * curr_yr.sales_cnt / prev_yr.sales_cnt < 0.9
        ORDER BY sales_cnt_diff, sales_amt_diff, curr_yr.i_brand_id,
                 curr_yr.i_class_id, curr_yr.i_category_id,
                 curr_yr.i_manufact_id
        LIMIT 100""",
    # per-channel promo-gated sales/returns/profit, LEFT JOIN
    # returns, ROLLUP(channel, id) (q80)
    "q80": """
        WITH ssr AS (
            SELECT s_store_id AS id,
                   SUM(ss_ext_sales_price) AS sales,
                   SUM(COALESCE(sr_return_amt, 0.0)) AS returns_amt,
                   SUM(ss_net_profit - COALESCE(sr_net_loss, 0.0))
                       AS profit
            FROM store_sales
            LEFT JOIN store_returns
              ON ss_ticket_number = sr_ticket_number
                 AND ss_item_sk = sr_item_sk
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            JOIN store ON ss_store_sk = s_store_sk
            JOIN item ON ss_item_sk = i_item_sk
            JOIN promotion ON ss_promo_sk = p_promo_sk
            WHERE d_year = 1998 AND i_current_price > 50
              AND p_channel_tv = 'N'
            GROUP BY s_store_id),
        csr AS (
            SELECT cp_catalog_page_id AS id,
                   SUM(cs_ext_sales_price) AS sales,
                   SUM(COALESCE(cr_return_amount, 0.0))
                       AS returns_amt,
                   SUM(cs_net_profit - COALESCE(cr_net_loss, 0.0))
                       AS profit
            FROM catalog_sales
            LEFT JOIN catalog_returns
              ON cs_order_number = cr_order_number
                 AND cs_item_sk = cr_item_sk
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            JOIN catalog_page
                 ON cs_catalog_page_sk = cp_catalog_page_sk
            JOIN item ON cs_item_sk = i_item_sk
            JOIN promotion ON cs_promo_sk = p_promo_sk
            WHERE d_year = 1998 AND i_current_price > 50
              AND p_channel_tv = 'N'
            GROUP BY cp_catalog_page_id),
        wsr AS (
            SELECT web_site_id AS id,
                   SUM(ws_ext_sales_price) AS sales,
                   SUM(COALESCE(wr_return_amt, 0.0)) AS returns_amt,
                   SUM(ws_net_profit - COALESCE(wr_net_loss, 0.0))
                       AS profit
            FROM web_sales
            LEFT JOIN web_returns
              ON ws_order_number = wr_order_number
                 AND ws_item_sk = wr_item_sk
            JOIN date_dim ON ws_sold_date_sk = d_date_sk
            JOIN web_site ON ws_web_site_sk = web_site_sk
            JOIN item ON ws_item_sk = i_item_sk
            JOIN promotion ON ws_promo_sk = p_promo_sk
            WHERE d_year = 1998 AND i_current_price > 50
              AND p_channel_tv = 'N'
            GROUP BY web_site_id)
        SELECT channel, id, SUM(sales) AS sales,
               SUM(returns_amt) AS returns_amt, SUM(profit) AS profit
        FROM (SELECT 'store channel' AS channel, id, sales,
                     returns_amt, profit
              FROM ssr
              UNION ALL
              SELECT 'catalog channel' AS channel, id, sales,
                     returns_amt, profit
              FROM csr
              UNION ALL
              SELECT 'web channel' AS channel, id, sales,
                     returns_amt, profit
              FROM wsr) x
        GROUP BY ROLLUP (channel, id)
        ORDER BY channel NULLS LAST, id NULLS LAST
        LIMIT 100""",
    # catalog returners above 1.2x their state's average return
    # (q81, correlated scalar subquery per state)
    "q81": """
        WITH customer_total_return AS (
            SELECT cr_returning_customer_sk AS ctr_customer_sk,
                   ca_state AS ctr_state,
                   SUM(cr_return_amount) AS ctr_total_return
            FROM catalog_returns
            JOIN date_dim ON cr_returned_date_sk = d_date_sk
            JOIN customer ON cr_returning_customer_sk = c_customer_sk
            JOIN customer_address ON c_current_addr_sk = ca_address_sk
            WHERE d_year = 1999
            GROUP BY cr_returning_customer_sk, ca_state)
        SELECT c_customer_id, c_first_name, c_last_name, ca_state,
               ctr_total_return
        FROM customer_total_return ctr1
        JOIN customer ON ctr1.ctr_customer_sk = c_customer_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        WHERE ctr1.ctr_total_return >
              (SELECT AVG(ctr_total_return) * 1.2
               FROM customer_total_return ctr2
               WHERE ctr1.ctr_state = ctr2.ctr_state)
        ORDER BY c_customer_id, c_first_name, c_last_name, ca_state,
                 ctr_total_return
        LIMIT 100""",
    # same-weeks return quantity share across 3 channels (q83)
    "q83": """
        WITH sr_items AS (
            SELECT i_item_id AS item_id,
                   SUM(sr_return_quantity) AS sr_item_qty
            FROM store_returns
            JOIN item ON sr_item_sk = i_item_sk
            JOIN date_dim ON sr_returned_date_sk = d_date_sk
            WHERE d_week_seq IN (5150, 5175, 5200)
            GROUP BY i_item_id),
        cr_items AS (
            SELECT i_item_id AS item_id,
                   SUM(cr_return_quantity) AS cr_item_qty
            FROM catalog_returns
            JOIN item ON cr_item_sk = i_item_sk
            JOIN date_dim ON cr_returned_date_sk = d_date_sk
            WHERE d_week_seq IN (5150, 5175, 5200)
            GROUP BY i_item_id),
        wr_items AS (
            SELECT i_item_id AS item_id,
                   SUM(wr_return_quantity) AS wr_item_qty
            FROM web_returns
            JOIN item ON wr_item_sk = i_item_sk
            JOIN date_dim ON wr_returned_date_sk = d_date_sk
            WHERE d_week_seq IN (5150, 5175, 5200)
            GROUP BY i_item_id)
        SELECT sr_items.item_id, sr_item_qty,
               sr_item_qty * 1.0 /
                   (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 *
                   100 AS sr_dev,
               cr_item_qty,
               cr_item_qty * 1.0 /
                   (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 *
                   100 AS cr_dev,
               wr_item_qty,
               wr_item_qty * 1.0 /
                   (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 *
                   100 AS wr_dev,
               (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
                   AS average
        FROM sr_items
        JOIN cr_items ON sr_items.item_id = cr_items.item_id
        JOIN wr_items ON sr_items.item_id = wr_items.item_id
        ORDER BY sr_items.item_id, sr_item_qty
        LIMIT 100""",
    # income-band city customers with store returns (q84)
    "q84": """
        SELECT c_customer_id AS customer_id, c_last_name,
               c_first_name
        FROM customer
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        JOIN customer_demographics
             ON c_current_cdemo_sk = cd_demo_sk
        JOIN household_demographics
             ON c_current_hdemo_sk = hd_demo_sk
        JOIN income_band ON hd_income_band_sk = ib_income_band_sk
        JOIN store_returns ON sr_cdemo_sk = cd_demo_sk
        WHERE ca_city = 'city5' AND ib_lower_bound >= 20000
          AND ib_upper_bound <= 170000
        ORDER BY c_customer_id
        LIMIT 100""",
    # 8 half-hour slot counts cross-joined (q88)
    "q88": """
        SELECT h8_30_to_9, h9_to_9_30, h9_30_to_10, h10_to_10_30,
               h10_30_to_11, h11_to_11_30, h11_30_to_12,
               h12_to_12_30
        FROM
        (SELECT COUNT(*) AS h8_30_to_9
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 8 AND t_minute >= 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s1
        CROSS JOIN
        (SELECT COUNT(*) AS h9_to_9_30
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 9 AND t_minute < 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s2
        CROSS JOIN
        (SELECT COUNT(*) AS h9_30_to_10
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 9 AND t_minute >= 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s3
        CROSS JOIN
        (SELECT COUNT(*) AS h10_to_10_30
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 10 AND t_minute < 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s4
        CROSS JOIN
        (SELECT COUNT(*) AS h10_30_to_11
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 10 AND t_minute >= 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s5
        CROSS JOIN
        (SELECT COUNT(*) AS h11_to_11_30
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 11 AND t_minute < 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s6
        CROSS JOIN
        (SELECT COUNT(*) AS h11_30_to_12
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 11 AND t_minute >= 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s7
        CROSS JOIN
        (SELECT COUNT(*) AS h12_to_12_30
         FROM store_sales
         JOIN household_demographics ON ss_hdemo_sk = hd_demo_sk
         JOIN time_dim ON ss_sold_time_sk = t_time_sk
         JOIN store ON ss_store_sk = s_store_sk
         WHERE t_hour = 12 AND t_minute < 30
           AND ((hd_dep_count = 3 AND hd_vehicle_count <= 5)
                OR (hd_dep_count = 0 AND hd_vehicle_count <= 2)
                OR (hd_dep_count = 1 AND hd_vehicle_count <= 3))
           AND s_store_name = 'store1') s8""",
    # brand/store monthly sales vs windowed average (q89)
    "q89": """
        SELECT i_category, i_class, i_brand, s_store_name,
               s_company_name, d_moy, sum_sales, avg_monthly_sales
        FROM (SELECT i_category, i_class, i_brand, s_store_name,
                     s_company_name, d_moy,
                     SUM(ss_sales_price) AS sum_sales,
                     AVG(SUM(ss_sales_price)) OVER
                         (PARTITION BY i_category, i_brand,
                                       s_store_name, s_company_name)
                         AS avg_monthly_sales
              FROM item
              JOIN store_sales ON ss_item_sk = i_item_sk
              JOIN date_dim ON ss_sold_date_sk = d_date_sk
              JOIN store ON ss_store_sk = s_store_sk
              WHERE d_year = 1999
                AND ((i_category IN ('Books', 'Electronics',
                                     'Sports')
                      AND i_class IN ('class1', 'class2', 'class3'))
                     OR (i_category IN ('Men', 'Jewelry', 'Women')
                         AND i_class IN ('class4', 'class5',
                                         'class6')))
              GROUP BY i_category, i_class, i_brand, s_store_name,
                       s_company_name, d_moy) tmp1
        WHERE CASE WHEN avg_monthly_sales <> 0
                   THEN ABS(sum_sales - avg_monthly_sales) /
                        avg_monthly_sales
                   ELSE NULL END > 0.1
        ORDER BY sum_sales - avg_monthly_sales, s_store_name,
                 i_category, i_class, i_brand, d_moy
        LIMIT 100""",
    # morning/evening web order ratio from two counts (q90)
    "q90": """
        SELECT amc * 1.0 / pmc AS am_pm_ratio
        FROM (SELECT COUNT(*) AS amc
              FROM web_sales
              JOIN household_demographics
                   ON ws_ship_hdemo_sk = hd_demo_sk
              JOIN time_dim ON ws_sold_time_sk = t_time_sk
              JOIN web_page ON ws_web_page_sk = wp_web_page_sk
              WHERE t_hour BETWEEN 8 AND 9 AND hd_dep_count = 6
                AND wp_char_count BETWEEN 2000 AND 6000) at_cnt
        CROSS JOIN
             (SELECT COUNT(*) AS pmc
              FROM web_sales
              JOIN household_demographics
                   ON ws_ship_hdemo_sk = hd_demo_sk
              JOIN time_dim ON ws_sold_time_sk = t_time_sk
              JOIN web_page ON ws_web_page_sk = wp_web_page_sk
              WHERE t_hour BETWEEN 19 AND 20 AND hd_dep_count = 6
                AND wp_char_count BETWEEN 2000 AND 6000) pt_cnt
        WHERE pmc > 0
        ORDER BY am_pm_ratio
        LIMIT 100""",
    # call-center returns by demographic segment (q91)
    "q91": """
        SELECT cc_call_center_id, cc_name, cc_manager,
               SUM(cr_net_loss) AS returns_loss
        FROM call_center
        JOIN catalog_returns
             ON cr_call_center_sk = cc_call_center_sk
        JOIN date_dim ON cr_returned_date_sk = d_date_sk
        JOIN customer ON cr_returning_customer_sk = c_customer_sk
        JOIN customer_demographics
             ON c_current_cdemo_sk = cd_demo_sk
        JOIN household_demographics
             ON c_current_hdemo_sk = hd_demo_sk
        JOIN customer_address ON c_current_addr_sk = ca_address_sk
        WHERE d_year = 1998 AND d_moy = 11
          AND ((cd_marital_status = 'M'
                AND cd_education_status = 'Unknown')
               OR (cd_marital_status = 'W'
                   AND cd_education_status = 'Advanced Degree'))
          AND hd_buy_potential = '0-500'
          AND ca_gmt_offset = -7.0
        GROUP BY cc_call_center_id, cc_name, cc_manager,
                 cd_marital_status, cd_education_status
        ORDER BY returns_loss DESC, cc_call_center_id, cc_name,
                 cc_manager
        LIMIT 100""",
    # web excess-discount vs 1.3x per-item average (q92)
    "q92": """
        SELECT SUM(ws1.ws_ext_discount_amt) AS excess_discount_amount
        FROM web_sales ws1
        JOIN item ON ws1.ws_item_sk = i_item_sk
        JOIN date_dim ON d_date_sk = ws1.ws_sold_date_sk
        WHERE i_manufact_id = 7
          AND d_year = 1999 AND d_moy BETWEEN 1 AND 4
          AND ws1.ws_ext_discount_amt >
              (SELECT 1.3 * AVG(ws2.ws_ext_discount_amt)
               FROM web_sales ws2
               WHERE ws2.ws_item_sk = ws1.ws_item_sk)
        LIMIT 100""",
    # actual sales net of reason-coded returns (q93)
    "q93": """
        SELECT ss_customer_sk, SUM(act_sales) AS sumsales
        FROM (SELECT ss_customer_sk,
                     CASE WHEN sr_return_quantity IS NOT NULL
                          THEN (ss_quantity - sr_return_quantity) *
                               ss_sales_price
                          ELSE ss_quantity * ss_sales_price
                          END AS act_sales
              FROM store_sales
              LEFT JOIN store_returns
                ON sr_item_sk = ss_item_sk
                   AND sr_ticket_number = ss_ticket_number
              JOIN reason ON sr_reason_sk = r_reason_sk
              WHERE r_reason_desc = 'reason 3') t
        GROUP BY ss_customer_sk
        ORDER BY sumsales, ss_customer_sk
        LIMIT 100""",
    # multi-warehouse shipped web orders, EXISTS + NOT EXISTS (q94)
    "q94": """
        SELECT COUNT(DISTINCT ws_order_number) AS order_count,
               SUM(ws_ext_ship_cost) AS total_shipping_cost,
               SUM(ws_net_profit) AS total_net_profit
        FROM web_sales ws1
        JOIN date_dim ON ws1.ws_ship_date_sk = d_date_sk
        JOIN web_site ON ws1.ws_web_site_sk = web_site_sk
        WHERE d_year = 1999 AND d_moy BETWEEN 2 AND 3
          AND EXISTS (SELECT 1 FROM web_sales ws2
                      WHERE ws1.ws_order_number = ws2.ws_order_number
                        AND ws1.ws_warehouse_sk <>
                            ws2.ws_warehouse_sk)
          AND NOT EXISTS (SELECT 1 FROM web_returns wr1
                          WHERE ws1.ws_order_number =
                                wr1.wr_order_number)
        LIMIT 100""",
    # returned multi-warehouse web orders via ws_wh CTE (q95)
    "q95": """
        WITH ws_wh AS (
            SELECT ws1.ws_order_number AS order_number
            FROM web_sales ws1
            JOIN web_sales ws2
              ON ws1.ws_order_number = ws2.ws_order_number
            WHERE ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
            GROUP BY ws1.ws_order_number)
        SELECT COUNT(DISTINCT ws_order_number) AS order_count,
               SUM(ws_ext_ship_cost) AS total_shipping_cost,
               SUM(ws_net_profit) AS total_net_profit
        FROM web_sales ws1
        JOIN date_dim ON ws1.ws_ship_date_sk = d_date_sk
        JOIN web_site ON ws1.ws_web_site_sk = web_site_sk
        WHERE d_year = 1999 AND d_moy BETWEEN 2 AND 3
          AND ws1.ws_order_number IN
              (SELECT order_number FROM ws_wh)
          AND ws1.ws_order_number IN
              (SELECT wr_order_number
               FROM web_returns
               JOIN ws_wh ON wr_order_number = order_number)
        LIMIT 100""",
    # store-vs-catalog customer-item overlap via FULL OUTER JOIN
    # (q97)
    "q97": """
        WITH ssci AS (
            SELECT ss_customer_sk AS customer_sk,
                   ss_item_sk AS item_sk
            FROM store_sales
            JOIN date_dim ON ss_sold_date_sk = d_date_sk
            WHERE d_month_seq BETWEEN 1190 AND 1200
            GROUP BY ss_customer_sk, ss_item_sk),
        csci AS (
            SELECT cs_bill_customer_sk AS customer_sk,
                   cs_item_sk AS item_sk
            FROM catalog_sales
            JOIN date_dim ON cs_sold_date_sk = d_date_sk
            WHERE d_month_seq BETWEEN 1190 AND 1200
            GROUP BY cs_bill_customer_sk, cs_item_sk)
        SELECT SUM(CASE WHEN ssci.customer_sk IS NOT NULL
                             AND csci.customer_sk IS NULL
                        THEN 1 ELSE 0 END) AS store_only,
               SUM(CASE WHEN ssci.customer_sk IS NULL
                             AND csci.customer_sk IS NOT NULL
                        THEN 1 ELSE 0 END) AS catalog_only,
               SUM(CASE WHEN ssci.customer_sk IS NOT NULL
                             AND csci.customer_sk IS NOT NULL
                        THEN 1 ELSE 0 END) AS store_and_catalog
        FROM ssci
        FULL OUTER JOIN csci
          ON ssci.customer_sk = csci.customer_sk
             AND ssci.item_sk = csci.item_sk
        LIMIT 100""",
}
