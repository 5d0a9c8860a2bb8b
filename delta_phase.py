"""Phase 5h of ``chip_smoke.py`` alone on the card.

Run from the repository's root on a machine with one CUDA card::

    python3 delta_phase.py

BASELINE configs 4 and 5 through the port's Delta layer and ML hand-off
(``chip_smoke.delta_phase``): H1 the MERGE / UPDATE upsert over
8,388,608 target and source rows, H2 B1 and B3 over the table's scanned
batches, H3 DELETE, OPTIMIZE ZORDER, VACUUM, two racing appends and a
duplicate-key MERGE, H4 the exactly-once stream with a crash child and
its resume, H5 the standard Delta format, H6 the mortgage ETL over
1,048,576 loans to device arrays; every result against numpy. It builds
the grouped kernel (B3) first, as the smoke does, prints the card's name
and power limit first and a JSON summary last; the command takes about
two minutes.
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
        print("delta_phase: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as CS
    from spark_rapids_tpu_torch.ops import device_kernels as DK
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t = time.perf_counter()
    DK.build_group_kernel()
    CS.log(f"build: nvcc tile_group_reduce {time.perf_counter() - t:.1f} s")
    dev = torch.device("cuda", 0)

    def read_counts():
        return {"tile_reduce": DK.tile_reduce.launches,
                "tile_reduce_str": DK.tile_reduce.str_launches,
                "tile_group_reduce": DK.tile_group_reduce.launches}
    report = CS.delta_phase(torch, np, dev, read_counts)
    print(json.dumps({"delta": report,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
