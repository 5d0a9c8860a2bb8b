"""Phase 5i of ``chip_smoke.py`` alone on the card, with what it needs.

Run from the repository's root on a machine with one CUDA card::

    python3 files_phase.py

It builds the grouped kernel (B3) and the host library as the smoke
does, generates the smoke's TPC-H tables (60M lineitem rows, moved to the
card) and their numpy references, runs q6 and q1 on the resident tables,
sorts lineitem by l_shipdate on the card and starts the files worker
(``chip_smoke.files_worker``, a process of its own that writes I1-I4's
files and I5's first Delta commits), registers the NDS tables at the smoke's scale, builds
``orders_nested`` on the card with its numpy references and resident N1
/ N2 runs, then calls ``chip_smoke.files_phase``: I1 row-group pruning,
I2 DPP, I3 nested Parquet, I4 ORC, I5 a Delta Parquet checkpoint. It
prints the card's name and power limit first and a JSON summary last (per
step its walls, launches and scan numbers); the command takes about
seven minutes.
"""

import json
import os
import subprocess
import sys
import time


def main():
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("files_phase: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as CS
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.io import host_lib as HL
    from spark_rapids_tpu_torch.models import nested as NM
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models.nds import register_nds
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    from spark_rapids_tpu_torch.plan.session import TpuSession
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t = time.perf_counter()
    DK.build_group_kernel()
    HL.library_path()
    CS.log(f"build: nvcc tile_group_reduce and the host library "
           f"{time.perf_counter() - t:.1f} s")
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    batches = {n: [] for n in CS.HOST_COLS}
    host = CS.tpch_host_lanes(np, lambda name, chunk: batches[name].append(
        table_to_batch(chunk, device=dev)))
    li, od, cu = host["lineitem"], host["orders"], host["customer"]
    files_w, _, _ = CS.start_files_worker(torch, np, batches["lineitem"])
    ref6, ref1 = CS.tpch_references(np, li, od, cu)[:2]
    conf = {"srt.sql.batchSizeRows": CS.BATCH_ROWS}
    session = TpuSession(SrtConf(conf), device=dev)
    dfs = {n: session.from_batches(b) for n, b in batches.items()}
    resident = {"q6": tpch.q6(dfs["lineitem"]).collect(),
                "q1": tpch.q1(dfs["lineitem"]).collect()}
    for name, ref in (("q6", ref6), ("q1", ref1)):
        CS.check(CS.same_rows(resident[name], ref),
                 f"resident {name} differs from numpy")
    CS.log(f"tpch: data, references and the resident runs in "
           f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    nds_session = TpuSession(SrtConf(conf), device=dev)
    nds_host = {}
    register_nds(nds_session, CS.NDS_ROWS, host_tables=nds_host)
    nds_ref = CS.NdsNumpy(np, nds_host)
    CS.log(f"nds: {CS.NDS_ROWS} scale rows registered in "
           f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    li_t, no, nt, _ = CS.nested_host_build(np, host)
    on = session.from_batches([table_to_batch(nt.slice(s, s + CS.BATCH_ROWS),
                                              device=dev)
                               for s in range(0, no.n, CS.BATCH_ROWS)])
    refs = NM.references(no, li_t)
    queries = NM.queries(NM.port_api(), on, dfs["lineitem"])
    nested_refs = {q: (refs[q], queries[q].collect())
                   for q in CS.FILES_NESTED_QUERIES}
    CS.log(f"nested: orders_nested on the card, its references and the "
           f"resident runs in {time.perf_counter() - t:.1f} s")
    del li_t, no, nt, refs, queries

    def read_counts():
        return {"tile_reduce": DK.tile_reduce.launches,
                "tile_reduce_str": DK.tile_reduce.str_launches,
                "tile_group_reduce": DK.tile_group_reduce.launches}
    try:
        report = CS.files_phase(torch, np, dev, read_counts, files_w,
                                (ref6, ref1), resident,
                                len(batches["lineitem"]),
                                (nds_session, nds_ref),
                                (dfs["lineitem"], nested_refs))
    finally:
        files_w.close()
    print(json.dumps({"files": report,
                      "device": torch.cuda.get_device_name(0)},
                     default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
