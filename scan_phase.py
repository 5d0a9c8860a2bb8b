"""Phase 5g of ``chip_smoke.py`` alone on the card, with what it needs.

Run from the repository's root on a machine with one CUDA card::

    python3 scan_phase.py

It starts G3's host half (``types_worker``) and the Parquet host
library's build as the smoke does, generates the smoke's TPC-H tables
(60M lineitem rows, moved to the card), computes their numpy references
(``tpch_references``) and runs q6, q1, q3 and the two string aggregates
once on the resident tables for the rows phase 5g holds its scans
against, then calls ``chip_smoke.scan_phase``. It prints the card's
name and power limit first and a JSON summary last (per query its walls,
launches and scan numbers); the command takes about four minutes.
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
        print("scan_phase: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as CS
    from spark_rapids_tpu_torch.conf import SrtConf
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    from spark_rapids_tpu_torch.plan.host_table import table_to_batch
    from spark_rapids_tpu_torch.plan.session import TpuSession
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    host_lib = CS.references_ahead([("host_lib", CS.build_host_lib)])
    scan_dir = (*CS.scan_root(np), int(1.3 * CS.SCAN_TYPES_ROWS * 97))
    types_w = CS.HostWorker(scan_dir[0], CS.SCAN_TYPES_ROWS,
                            target=CS.types_worker)
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    batches = {n: [] for n in CS.HOST_COLS}
    host = CS.tpch_host_lanes(np, lambda name, chunk: batches[name].append(
        table_to_batch(chunk, device=dev)))
    li, od, cu = host["lineitem"], host["orders"], host["customer"]
    refs = CS.tpch_references(np, li, od, cu)[:5]
    session = TpuSession(SrtConf({"srt.sql.batchSizeRows": CS.BATCH_ROWS}),
                         device=dev)
    dfs = {n: session.from_batches(b) for n, b in batches.items()}
    queries = CS.scan_queries(refs, len(batches["lineitem"]),
                              len(batches["orders"]))
    resident = {}
    for name, (make, ref, _, _) in queries.items():
        resident[name] = make(dfs).collect()
        CS.check(CS.same_rows(resident[name], ref),
                 f"resident {name} differs from numpy")
    CS.log(f"data, references and the resident runs in "
           f"{time.perf_counter() - t:.1f} s")

    def read_counts():
        return {"tile_reduce": DK.tile_reduce.launches,
                "tile_reduce_str": DK.tile_reduce.str_launches,
                "tile_group_reduce": DK.tile_group_reduce.launches}
    report = CS.scan_phase(torch, np, dev, host, dfs, queries, resident,
                           read_counts, {"allow": False, "plans": 0},
                           host_lib, scan_dir, types_w)
    print(json.dumps({"scan": report,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
