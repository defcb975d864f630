"""Multi-process serving smoke: two processes join one group through
``--coordinator`` and serve reduced moonshot-v1-16b-a3b with its experts
split between them, on the CPU (gloo).  Fails unless every process exits
0 and rank 0 reports every request completed.

    PYTHONPATH=src python -m repro_torch.launch.mp_serve_smoke [--processes 2]

Counterpart of the reference's ``tools/mp_serve_smoke.py``, whose
single-process fallback has no counterpart here: the port's multi-process
path runs on the CPU."""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REQUESTS, TIMEOUT_S = 3, 420
LAUNCH = [sys.executable, "-m", "repro_torch.launch.serve",
          "--arch", "moonshot-v1-16b-a3b", "--reduce",
          "--requests", str(REQUESTS), "--max-new", "3", "--device", "cpu",
          "--distributed"]


def main(argv=None) -> None:
    from repro_torch.distributed import free_port
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    args = ap.parse_args(argv)
    port = free_port()
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        LAUNCH + ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                  str(args.processes), "--process-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(args.processes)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ok = (all(p.returncode == 0 for p in procs)
          and f"{REQUESTS}/{REQUESTS} requests completed" in outs[0])
    sys.stdout.write(outs[0])
    if not ok:
        for i, (p, out) in enumerate(zip(procs, outs)):
            print(f"--- process {i} (exit code {p.returncode}) ---\n{out}")
        raise SystemExit(f"{args.processes}-process serving failed")
    print(f"{args.processes}-process serving: every request completed")
    print("mp serve smoke OK")


if __name__ == "__main__":
    main()
