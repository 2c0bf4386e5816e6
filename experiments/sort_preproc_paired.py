"""B3 (the whole-clip SORT scan) and B1 (letterbox preprocessing) of two
checkouts on one card, in turns: each run, in its own process and with
its own kernels built under its own ``build/``, times

- B1 at the serving shape, [8, 480, 640, 3] uint8 -> [8, 512, 512, 3];
- B3 on the fourth clip of ``chip_smoke.py``'s coherent scene (6 clips
  of 40 objects, K=128, D=64, T=8, the state threaded by the kernel);
- B3 on each of the two clips of the detections of the full-width fused
  pipeline that ``chip_smoke.py`` drives (seeded weights and frames,
  score threshold 0, so all 64 detections of a frame are valid),

as ``a, b, b, a``.  The pipeline's detections are made once, by this
checkout, and saved under ``build/``.

    python experiments/sort_preproc_paired.py OTHER_CHECKOUT

``OTHER_CHECKOUT`` is a checkout of another commit (``a``); this
repository is ``b``.  Prints one JSON line per run, and the card's name
and power limit.  Kernel times (ms) are mean device times of one launch
from ``torch.profiler``; "a call" is the CUDA-event time of back-to-back
calls, which measures the host's enqueue where that takes longer.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETS = os.path.join(REPO, "build", "pipeline_dets.npz")

DUMP = """
import sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
import chip_smoke as c
from tao_amodal_torch.pipeline import AmodalPipeline
dev = torch.device('cuda', 0)
pipe = AmodalPipeline.create(device=dev).init(
    torch.Generator(device=dev).manual_seed(0))
fused = AmodalPipeline.create(device=dev, fused_stages=c.FUSED)
fused.load_state_dict(pipe.state_dict())
rs = np.random.RandomState(3)
boxes, valid = [], []
state = fused.init_tracker_state()
for _ in range(2):
    raw = rs.randint(0, 256, (c.T, c.H, c.W, 3), dtype=np.uint8)
    clip, _ = fused.preprocess(torch.from_numpy(raw).to(dev), out_size=c.S)
    out, state = fused.streaming(clip, state, score_thr=0.0)
    boxes.append(out['visible_boxes'].cpu().numpy())
    valid.append((out['scores'] > 0.0).cpu().numpy())
np.savez(sys.argv[1], boxes=np.stack(boxes), valid=np.stack(valid))
"""

RUN = """
import json, sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
from tao_amodal_torch import _build
from tao_amodal_torch.ops import preproc, sort_scan
from tao_amodal_torch.trackers.sort import init_sort
from torch_port_fixtures import coherent_scene
_build.build()
_build.library()
dev = torch.device('cuda', 0)


def device_ms(fn, kernel, reps):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if kernel in e.key and e.device_time_total > 0]
    n = sum(e.count for e in ev)
    return sum(e.device_time_total for e in ev) / 1e3 / n if n else None


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


kw = dict(max_age=5, min_hits=1)
frames = torch.from_numpy(np.random.RandomState(0).randint(
    0, 256, (8, 480, 640, 3), dtype=np.uint8)).to(dev)
b1 = lambda: preproc.preprocess_frames(frames, 512)
res = {'B1 ms': device_ms(b1, 'preproc_kernel', 200),
       'B1 ms a call': cuda_ms(b1, 500)}
b, v = coherent_scene(7, frames=48, objects=40, D=64, extent=600)
clips = [(torch.from_numpy(b[i:i + 8]).to(dev),
          torch.from_numpy(v[i:i + 8]).to(dev)) for i in range(0, 48, 8)]
state = init_sort(128, device=dev)
for i in range(3):
    state, _ = sort_scan.sort_scan_pallas(state, *clips[i], **kw)
b3 = lambda: sort_scan.sort_scan_pallas(state, *clips[3], **kw)
res['B3 coherent ms'] = device_ms(b3, 'sort_scan_kernel', 200)
res['B3 coherent ms a call'] = cuda_ms(b3, 500)
d = np.load(sys.argv[1])
state, ms, ids = init_sort(128, device=dev), [], []
for bx, vl in zip(d['boxes'], d['valid']):
    bx, vl = torch.from_numpy(bx).to(dev), torch.from_numpy(vl).to(dev)
    ms.append(device_ms(lambda: sort_scan.sort_scan_pallas(
        state, bx, vl, **kw), 'sort_scan_kernel', 200))
    state, (i, _) = sort_scan.sort_scan_pallas(state, bx, vl, **kw)
    ids.append(i.cpu())
res['B3 pipeline ms per clip'] = ms
res['B3 pipeline ids checksum'] = int(sum(int(i.long().sum()) for i in ids))
print('RESULT ' + json.dumps(res))
"""


def run(cwd, script, *args):
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.exit(f"{cwd} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"a": os.path.abspath(sys.argv[1]), "b": REPO}
    os.makedirs(os.path.dirname(DETS), exist_ok=True)
    run(REPO, DUMP, DETS)
    for label in "abba":
        for line in run(trees[label], RUN, DETS).splitlines():
            if line.startswith("RESULT "):
                print(f"[{label}] {line[7:]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
