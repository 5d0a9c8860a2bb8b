#!/usr/bin/env python3
"""F5 of the fallback phase with and without column pruning at its seams.

    python3 seam_pruning.py

Needs one CUDA card. Puts the NDS tables on the card at ``scale_rows``
28,800,000 (as chip_smoke.py's NDS phase does), then runs F5
(``models/fallback.py``: store_sales x item x date_dim for June 1999 on
the device, two windows on the CPU engine) as the planner builds it,
where a DeviceToHost seam moves only the columns the host side reads
(``plan/overrides.py::_kept``), and with that pruning turned off, where
every column of the joined rows crosses. One first run each way, then
timed runs in the order pruned, unpruned, unpruned, pruned; every run
is held against chip_smoke.py's numpy reference. Logs each run's wall,
the rows and bytes across the seams and the seconds in the seams and in
the CPU engine, then prints a JSON summary as its last line.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import chip_smoke as CS


def f5_runs(torch, np, dev, rows, order):
    """{mode: [run, ...]} for F5 over NDS tables at ``rows``, each run's
    wall, seam rows / bytes / seconds and CPU-engine seconds; ``order``
    names the modes ("pruned" or "unpruned") run by run."""
    from spark_rapids_tpu_torch.models import fallback as FB
    from spark_rapids_tpu_torch.plan import overrides as OV
    session, ref = CS.nds_session_at(torch, np, dev, rows)
    want = CS.f5_reference(np, ref)

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    out = {"pruned": [], "unpruned": []}
    for mode in order:
        off = mock.patch.object(OV, "_kept", lambda schema, need: None)
        with (off if mode == "unpruned" else contextlib.nullcontext()):
            df = session.sql(FB.F5)
            sync()
            t = time.perf_counter()
            table = df.to_table()
            sync()
            wall = time.perf_counter() - t
        CS.same_f5(np, table, want)
        totals = session._last_execution[1].metric_totals()
        run = {"wall_s": wall,
               "seam_rows": totals.get("transitionRows", 0),
               "seam_bytes": totals.get("transitionBytes", 0),
               "seam_s": totals.get("transitionTimeNs", 0) / 1e9,
               "cpu_engine_s": totals.get("cpuTimeNs", 0) / 1e9}
        out[mode].append(run)
        CS.log(f"F5 {mode}: matches the reference; {json.dumps(run)}")
    return out


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("seam_pruning: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    CS.log(f"card: {smi}")
    order = ["pruned", "unpruned", "pruned", "unpruned", "unpruned",
             "pruned"]
    runs = f5_runs(torch, np, torch.device("cuda", 0), CS.NDS_ROWS, order)
    # the first run of each way builds and warms; the rest are timed
    summary = {"card": smi, "rows": CS.NDS_ROWS}
    for mode, rs in runs.items():
        timed = rs[1:]
        summary[mode] = {
            "first_wall_s": rs[0]["wall_s"],
            "warm_walls_s": [r["wall_s"] for r in timed],
            "median_wall_s": statistics.median(r["wall_s"] for r in timed),
            "median_seam_s": statistics.median(r["seam_s"] for r in timed),
            "median_cpu_engine_s": statistics.median(r["cpu_engine_s"]
                                                     for r in timed),
            "seam_rows": timed[-1]["seam_rows"],
            "seam_bytes": timed[-1]["seam_bytes"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
