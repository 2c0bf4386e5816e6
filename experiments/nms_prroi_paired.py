"""Greedy NMS and the bf16 PrRoI kernel (``tao_prroi_bf16``, forms 0-2)
of two checkouts on one card, in turns.  Each run, in its own process
and with its own kernels built under its own ``build/``, times

- the whole ``ops/nms.py::nms_keep_mask`` (every kernel it launches,
  from the boxes to the keep mask) on the NMS calls of two clips of the
  full-width f32 pipeline that ``chip_smoke.py`` captures (seeded
  weights and frames, score threshold 0: the RPN's [8, 448] at 0.7 and
  the detector's class-offset [8, 96] at 0.5), and on the RPN's calls
  tiled to ``batched``'s 32 frames;
- the bf16 forms of B2, B5 and B6 on the JAX bench's 384x512 serving
  shapes (a seeded bf16 P3..P6 pyramid, C = 256, 96 RoIs a frame: B2 on
  the 48x98 canvas, B5 on it padded to 112 columns, B6 on each level,
  summed),

as ``a, b, b, a``, on inputs made once by this checkout and saved under
``build/``; and holds the keep masks and the bf16 outputs of the two
checkouts against each other bit for bit.

    python experiments/nms_prroi_paired.py OTHER_CHECKOUT

``OTHER_CHECKOUT`` is a checkout of another commit (``a``); this
repository is ``b``.  Prints one JSON line per run, the comparison, and
the card's name and power limit.  Times (ms) are device times from
``torch.profiler``, per call (mean of 20 calls), all kernels of a call.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "build", "nms_prroi_inputs.pt")

DUMP = """
import sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
import chip_smoke as c
from tao_amodal_torch.ops import nms, roi
from tao_amodal_torch.pipeline import AmodalPipeline
dev = torch.device('cuda', 0)
pipe = AmodalPipeline.create(device=dev).init(
    torch.Generator(device=dev).manual_seed(70))
rs = np.random.RandomState(70)
seen, real = [], nms.nms_keep_mask
def rec(boxes, scores, thr, valid=None, *args):
    seen.append((boxes.cpu(), scores.cpu(), thr))
    return real(boxes, scores, thr, valid, *args)
rec.launches = 0
nms.nms_keep_mask = rec
state = pipe.init_tracker_state()
for _ in range(2):
    raw = rs.randint(0, 256, (c.T, c.H, c.W, 3), dtype=np.uint8)
    clip, _ = pipe.preprocess(torch.from_numpy(raw).to(dev), out_size=c.S)
    _, state = pipe.streaming(clip, state, score_thr=0.0)
nms.nms_keep_mask = real
rpn = [x for x in seen if x[1].shape[-1] > 200]
seen.append((torch.cat([x[0] for x in rpn] * 2),
             torch.cat([x[1] for x in rpn] * 2), rpn[0][2]))
g = torch.Generator(device=dev).manual_seed(21)
pyramid = [torch.randn((c.T, h, w, 256), generator=g, device=dev).to(
    torch.bfloat16) for h, w in c.BF16_LEVELS]
rois = c.serving_rois(torch, dev, 22, c.BF16_OUT)
b2 = roi.pack_levels(pyramid, rois, canonical_level=1,
                     strides=c.LEVEL_STRIDES)
b5 = roi.pack_levels(pyramid, rois, canonical_level=1,
                     strides=c.LEVEL_STRIDES, width_multiple=16)
torch.save(dict(nms=seen, b2=[t.cpu() for t in b2],
                b5=[t.cpu() for t in b5],
                levels=[p.cpu() for p in pyramid], rois=rois.cpu(),
                strides=c.LEVEL_STRIDES), sys.argv[1])
"""

RUN = """
import json, sys, torch
sys.path[:0] = ['.']
from tao_amodal_torch import _build
from tao_amodal_torch.ops import nms, prroi
_build.build()
_build.library()
dev = torch.device('cuda', 0)


def device_ms(fn, reps=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_time_total > 0]
        if ev:
            return (sum(e.device_time_total for e in ev) / 1e3 / reps,
                    sum(e.count for e in ev) / reps)
    raise RuntimeError('the profiler recorded no kernel')


data = torch.load(sys.argv[1])
res, outs = {}, {}
for i, (boxes, scores, thr) in enumerate(data['nms']):
    call = (boxes.to(dev), scores.to(dev), thr)
    ms, events = device_ms(lambda: nms.nms_keep_mask(*call))
    key = f'nms {tuple(scores.shape)} call {i}'
    res[key] = dict(ms=ms, events=events)
    outs[key] = nms.nms_keep_mask(*call).cpu()
for name, fn, (canvas, rois_p) in (
        ('B2 form 0', prroi.prroi_packed, data['b2']),
        ('B5 form 1', prroi.prroi_packed_pallas, data['b5'])):
    args = (canvas.to(dev), rois_p.to(dev))
    res[name] = dict(ms=device_ms(lambda: fn(*args))[0])
    outs[name] = fn(*args).cpu()
rois = data['rois'].to(dev)
levels = [(p.to(dev), rois, 7, 1.0 / s)
          for p, s in zip(data['levels'], data['strides'])]
res['B6 form 2, four levels'] = dict(ms=sum(
    device_ms(lambda: prroi.prroi_pool_pallas(*a))[0] for a in levels))
outs['B6 form 2'] = [prroi.prroi_pool_pallas(*a).cpu() for a in levels]
torch.save(outs, sys.argv[2])
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
    import torch

    trees = {"a": os.path.abspath(sys.argv[1]), "b": REPO}
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    run(REPO, DUMP, INPUTS)
    outs = {}
    for i, label in enumerate("abba"):
        path = os.path.join(REPO, "build", f"nms_prroi_out_{i}.pt")
        for line in run(trees[label], RUN, INPUTS, path).splitlines():
            if line.startswith("RESULT "):
                print(f"[{label}] {line[7:]}", flush=True)
        outs.setdefault(label, torch.load(path))
    same = {}
    for key, a in outs["a"].items():
        b = outs["b"][key]
        same[key] = (all(torch.equal(x, y) for x, y in zip(a, b))
                     if isinstance(a, list) else torch.equal(a, b))
    print("bit-equal a vs b: " + json.dumps(same), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
