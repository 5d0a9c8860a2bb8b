"""Phase 5f of ``chip_smoke.py`` alone on the card, with what it needs.

Run from the repository's root on a machine with one CUDA card::

    python3 surface_phase.py

It generates the TPC-H tables of the smoke (60M lineitem rows), runs q6
and q1 once for the launch counts phase 5f compares its ANSI runs with,
makes the DECIMAL(12,2) lanes and ``orders_nested`` (N6's documents cut
to their first batch), and calls ``chip_smoke.surface_phase``, whose
references come from the same ``host_worker`` process the smoke uses.
Before the phase it measures, over lineitem's first 4,194,304 prices,
how many rows of the float -> DECIMAL(24,4) cast's HALF_UP midpoint
test differ on the card between dividing by a Python float (PyTorch
multiplies by its reciprocal on CUDA) and by a tensor (``true_div``),
and between the card's and the CPU's cast (ROADMAP C22). It prints the
card's name and power limit first and a JSON summary last; the phase
takes about 45 s, the whole command about 3.5 minutes.
"""

import json
import os
import subprocess
import sys
import time


def decimal_cast_check(torch, np, CS, dev):
    """{rows, midpoint rows where scalar and tensor division differ,
    rows whose DECIMAL(24,4) cast differs between the card and the
    CPU}, over lineitem's first SURFACE_HASH_BATCHES batches."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.datagen import generate_chunk
    from spark_rapids_tpu_torch.expr.cast import cast_column
    from spark_rapids_tpu_torch.expr.core import true_div
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    spec = tpch.tpch_table_specs(CS.ROWS)[0]
    t = dt.DecimalType(24, 4)
    out = {"rows": 0, "scalar_div_differs": 0, "card_cpu_cast_differs": 0}
    for c in range(CS.SURFACE_HASH_BATCHES):
        chunk = generate_chunk(spec, c, CS.BATCH_ROWS)
        cols = [table_to_batch(chunk, device=d).column("l_extendedprice")
                for d in (dev, "cpu")]
        x = cols[0].data.abs()
        q = torch.floor(x * 1e4)
        out["scalar_div_differs"] += int(
            ((q + 0.5) / 1e4 != true_div(q + 0.5, 1e4)).sum())
        card, cpu = (cast_column(col, t) for col in cols)
        out["card_cpu_cast_differs"] += int(
            (card.lo.cpu() != cpu.lo).sum())
        out["rows"] += chunk.num_rows
    return out


def main():
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("surface_phase: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models import nested as NM
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    from spark_rapids_tpu_torch.plan.session import TpuSession
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    worker = CS.HostWorker(("tpch", "surface"), "UTC", 1)
    try:
        dev = torch.device("cuda", 0)
        check = decimal_cast_check(torch, np, CS, dev)
        CS.log(f"decimal cast (ROADMAP C22): {json.dumps(check)}")
        DK.build_group_kernel()
        batches = {n: [] for n in CS.HOST_COLS}
        host = CS.tpch_host_lanes(np, lambda name, chunk: batches[
            name].append(table_to_batch(chunk, device=dev)))
        conf = SrtConf({"srt.sql.batchSizeRows": CS.BATCH_ROWS})
        session = TpuSession(conf, device=dev)
        li = session.from_batches(batches["lineitem"])

        def read_counts():
            return {"tile_reduce": DK.tile_reduce.launches,
                    "tile_reduce_str": DK.tile_reduce.str_launches,
                    "tile_group_reduce": DK.tile_group_reduce.launches}
        launches = {}
        for name, q in (("q6", tpch.q6), ("q1", tpch.q1)):
            DK.reset_counts()
            q(li).collect()
            launches[name] = read_counts()
        (ref6, ref1, *_), _, _, _ = worker.get("tpch")
        dec_session = TpuSession(conf, device=dev)
        for name, bs in batches.items():
            dec_session.create_or_replace_temp_view(
                name, dec_session.from_batches(CS.decimal_batches(torch, bs)))
        t = time.perf_counter()
        li_t, od_t = CS.nested_host_tables(np, host)
        no = NM.NestedOrders(li_t)
        nt = no.table()
        on_batches = [table_to_batch(nt.slice(s, s + CS.BATCH_ROWS),
                                     device=dev)
                      for s in range(0, no.n, CS.BATCH_ROWS)]
        docs = NM.json_docs(no, od_t, CS.NESTED_JSON_BATCH)
        json_batches = [table_to_batch(NM.json_table(docs), device=dev)]
        n4x = NM.references(no, li_t)["N4_explode"]
        CS.log(f"nested batches and {len(docs)} documents in "
               f"{time.perf_counter() - t:.1f} s")
        report = CS.surface_phase(
            torch, np, dev, session, batches, host, dec_session,
            (on_batches, json_batches, n4x), worker, read_counts,
            (ref6, ref1), launches, {"allow": False})
    finally:
        worker.close()
    print(json.dumps({"decimal_cast": check, "seconds": report["seconds"],
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
