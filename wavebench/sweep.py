"""Find the knee of an open-loop pool cell once, on the card: the highest
offered rate at which the pool's queue does not grow across the window.

    python3 wavebench/sweep.py --workload chaconne.pool_open --seed 7 \
        --seconds 20 --rates 20,30,40

Each rate is one run of the cell's own load (``loads/pool.py``) with the
mix's ``rate_per_s`` replaced, on a fresh pool; a line per rate gives the
queue at the window's edges, the admitted rate, the samples delivered a
second, the lanes busy at the close, the median and 95th percentile of
the time to first audio and the check's gap. Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wavebench.run import pin_caches  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    a = ap.parse_args(argv)
    pin_caches()
    import torch

    from wavebench import loads, spec, tracing
    from wavebench.loads import pool

    cell = spec.load_cell(a.workload)
    dev = torch.device("cuda", 0)
    for rate in [float(x) for x in a.rates.split(",")]:
        ctx = loads.Context(cell.model_fields(),
                            dict(cell.traffic, rate_per_s=rate), a.seed,
                            a.seconds, False, dev,
                            tracing.Capture(False, ""), time.perf_counter())
        rec = pool.run(ctx)
        s0, s1 = rec.x["stats0"], rec.x["stats1"]
        print(json.dumps({
            "rate_per_s": rate, "queued_open": s0["queued"],
            "queued_close": s1["queued"],
            "admitted_per_s": (s1["admitted"] - s0["admitted"]) / a.seconds,
            "samples_per_s": rec.x["samples_in_window"] / a.seconds,
            "active_close": s1["active"],
            "ttfa_p50_ms": rec.x["ttfa_p50_ms"],
            "ttfa_p95_ms": rec.e2e["ttfa_p95_ms"],
            "requests": rec.attempted, "gap": rec.compared["gap"]}),
            flush=True)


if __name__ == "__main__":
    main()
