"""The auction kernel (``csrc/auction.cu::tao_auction_rounds``) of two or
more checkouts on one card, in turns.  Each run, in its own process and
with its kernels built under its own ``build/``, times

- the frames of ``chip_smoke.py``'s ``phase_auction``: SORT over the
  detections of its unfused full-width f32 run (seed 0, the clips of
  ``RandomState(3)``, score threshold 0, TF32 off: SORT's [64, 128]
  benefits, its 53-round frame among them), recorded once by this
  checkout for each of ``sort_step``'s auctions (``gated_auction`` and
  ``auction``: the state, so the benefits, differ) and saved under
  ``build/``;
- SORT-like frames (``torch_port_fixtures.sort_benefits``) at
  ``[192, 384]`` and ``[256, 512]``, past a block's shared memory (a
  checkout that refuses them reports null);
- the eviction chains of ``torch_port_fixtures.auction_chain`` at 48
  and 300 rows (one round of every row, then single-row rounds),

each launch's device time from ``torch.profiler`` (mean of 20; null
where three traces in a row held no kernel), with
the kernel's own rounds and a digest of its assignments, which must
agree between the checkouts.

    python experiments/auction_paired.py OTHER_CHECKOUT [MORE ...]

The checkouts run in the order given, then this repository, then all
of them again in reverse (``a, b, b, a`` for one other).  Prints one
JSON line per run, and the card's name and power limit.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENEFITS = os.path.join(REPO, "build", "auction_benefits.npz")

DUMP = """
import sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
import chip_smoke as c
from tao_amodal_torch.ops import sort_scan
from tao_amodal_torch.pipeline import AmodalPipeline
from tao_amodal_torch.trackers import sort
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device('cuda', 0)
pipe = AmodalPipeline.create(device=dev).init(
    torch.Generator(device=dev).manual_seed(0))
rs = np.random.RandomState(3)
dets, state = [], pipe.init_tracker_state()
for _ in range(2):
    raw = rs.randint(0, 256, (c.T, c.H, c.W, 3), dtype=np.uint8)
    clip, _ = pipe.preprocess(torch.from_numpy(raw).to(dev), out_size=c.S)
    out, state = pipe.streaming(clip, state, score_thr=0.0)
    dets.append((out['visible_boxes'], out['scores'] > 0.0))
real, saved = sort.auction_assign, {}
for assignment in ('gated_auction', 'auction'):
    seen = []
    def rec(b, *args, **kw):
        seen.append(b.cpu().numpy())
        return real(b, *args, **kw)
    sort.auction_assign = rec
    st = sort.init_sort(c.SORT_K, device=dev)
    for boxes, valid in dets:
        st, _ = sort_scan.sort_scan(st, boxes, valid, assignment=assignment,
                                    max_age=pipe.sort_max_age,
                                    min_hits=pipe.sort_min_hits)
    sort.auction_assign = real
    saved[assignment] = np.stack(seen)
np.savez(sys.argv[1], **saved)
"""

RUN = """
import hashlib, json, sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
from tao_amodal_torch import _build
from tao_amodal_torch.ops import hungarian
sys.path[:0] = [sys.argv[2]]
from torch_port_fixtures import auction_chain, sort_benefits
_build.build()
_build.library()
dev = torch.device('cuda', 0)
SETTINGS = {'gated_auction': dict(eps=1e-3, floor=0.8 * 0.3),
            'auction': dict(eps=5e-5, floor=-1e-3)}


def device_ms(fn, reps=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if 'auction_rounds_kernel' in e.key and e.device_time_total > 0]
        if ev:
            return sum(e.device_time_total for e in ev) / 1e3 / reps
    return None  # three traces without the kernel: not measured


def frame(b, setting):
    b = torch.from_numpy(b).to(dev)
    r = torch.zeros(1, dtype=torch.int32, device=dev)
    try:
        got = hungarian.auction_assign(b, **setting, rounds=r)
    except ValueError:
        return None, None, None
    digest = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()[:12]
    return (device_ms(lambda: hungarian.auction_assign(b, **setting)),
            int(r), digest)


res = {}
saved = np.load(sys.argv[1])
for name, setting in SETTINGS.items():
    runs = [frame(b, setting) for b in saved[name]]
    ms = [t for t, _, _ in runs]
    res[name] = {'ms by frame': ms, 'rounds': [k for _, k, _ in runs],
                 'ms a clip': [None if None in ms[i:i + 8] else
                               sum(ms[i:i + 8])
                               for i in range(0, len(ms), 8)],
                 'digest': hashlib.sha1(''.join(
                     d for _, _, d in runs).encode()).hexdigest()[:12]}
    for D in (192, 256):
        res[name][f'[{D}, {2 * D}]'] = [
            frame(b, setting) for b in sort_benefits(D, n=D, m=2 * D,
                                                     frames=2)]
    for n in (48, 300):
        res[name][f'chain {n}'] = frame(auction_chain(n), setting)
print('RESULT ' + json.dumps(res))
"""


def run(cwd, script, *args):
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.exit(f"{cwd} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    trees = [os.path.abspath(p) for p in sys.argv[1:]] + [REPO]
    os.makedirs(os.path.dirname(BENEFITS), exist_ok=True)
    run(REPO, DUMP, BENEFITS)
    tests = os.path.join(REPO, "tests")
    for tree in trees + trees[::-1]:
        for line in run(tree, RUN, BENEFITS, tests).splitlines():
            if line.startswith("RESULT "):
                print(f"[{os.path.basename(tree)}] {line[7:]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
