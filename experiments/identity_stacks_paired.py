"""B7 and B8 (the identity-bottleneck stacks) of two checkouts on one
card, in turns: ``chip_smoke.py``'s ``check_stacks`` of each, run as
``a, b, b, a`` in separate processes (each builds its own kernels under
its own ``build/``), so that two versions are compared within one call.

    python experiments/identity_stacks_paired.py OTHER_CHECKOUT

``OTHER_CHECKOUT`` is a checkout of another commit (``a``); this
repository is ``b``.  Prints each run's per-stage and four-stage lines,
labelled, and the card's name and power limit.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import sys, torch
sys.path[:0] = ['.', 'tests']
import chip_smoke as c
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
c.phase_build()
c.check_stacks(torch, torch.device('cuda', 0))
"""


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"a": os.path.abspath(sys.argv[1]), "b": REPO}
    for label in "abba":
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[label],
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if " stage " in line or "four stages" in line:
                print(f"[{label}] {line}", flush=True)
        if proc.returncode != 0:
            sys.exit(f"[{label}] failed:\n{proc.stderr[-4000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
