"""Where does a pipelined serving round's extra time come from?

Runs ``chip_smoke.py``'s ``serve`` workload (``bench.py --serve``'s 256
``LinearRCZone`` tenants under ``churn_schedule(0, 256, 16)``, f32) on the
card through four plane configurations, in turns (A B C D D C B A), all
planes sharing one engine cache so only the first builds:

* A: sync, no watchdog (the step on the main thread);
* B: pipelined, no watchdog;
* C: pipelined under the watchdog (the serve phase's pipelined leg: the
  launch and the decode on the watchdog's worker thread);
* D: sync under the watchdog (the step on the worker thread, no
  pipelining).

Prints one JSON line per plane (mean, p50 and p99 warm round ms, solves
per second, delivered results) and a summary line with each
configuration's median of means, then the card's name and power limit.
Needs one CUDA card; about 3 minutes of command time::

    python3 scripts/serve_dispatch_ab.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CONFIGS = {"A_sync": (False, None), "B_pipelined": (True, None),
           "C_pipelined_watchdog": (True, 60.0),
           "D_sync_watchdog": (False, 60.0)}
ORDER = ("A_sync", "B_pipelined", "C_pipelined_watchdog",
         "D_sync_watchdog", "D_sync_watchdog", "C_pipelined_watchdog",
         "B_pipelined", "A_sync")


def main() -> int:
    import torch

    import chip_smoke as cs
    from agentlib_mpc_torch.serving import CompileCache

    if not torch.cuda.is_available():
        print("serve_dispatch_ab: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cache = CompileCache()
    sync = torch.cuda.synchronize
    means: dict = {name: [] for name in CONFIGS}
    for name in ORDER:
        pipelined, watchdog = CONFIGS[name]
        plane = cs.serve_plane(torch, cs.SERVE_TENANTS, dev, torch.float32,
                               pipelined, cache=cache, watchdog_s=watchdog)
        t0 = time.perf_counter()
        run = cs.serve_run(torch, cs.SERVE_TENANTS, cs.SERVE_ROUNDS, dev,
                           torch.float32, pipelined, sync, plane=plane)
        means[name].append(run["round_ms_mean"])
        print(json.dumps({
            "plane": name, "seconds": time.perf_counter() - t0,
            "round_ms_mean": run["round_ms_mean"],
            "round_ms_p50": run["round_ms_p50"],
            "round_ms_p99": run["round_ms_p99"],
            "solves_per_sec": run["solves_per_sec"],
            "delivered": run["delivered"],
            "stalls": plane.dispatcher.stalls}), flush=True)
    print(json.dumps({"summary": {k: float(np.median(v))
                                  for k, v in means.items()},
                      "runs": means}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
