"""The int8 trunk's activation quantizer (``tao_quantize_s8``) and the
greedy assignment's fixpoint (``tao_greedy_fixpoint``) of two checkouts
on one card, in turns.  Each run, in its own process and with its own
kernels built under its own ``build/``, times

- the quantizer on the inputs of the 53 convs of the int8 ResNet-50
  trunk at 512^2, T=8 (the NCHW view of an NHWC f32 activation, seeded,
  its abs-max at a seeded place), a clip's worth in the order the trunk
  runs them: 53 quantizations, or 49 where the checkout shares a
  bottleneck's first-conv quantization with its projection
  (``ConvBN.quantize_input``);
- the greedy kernel on every frame of three clips of the full-width f32
  pipeline that ``chip_smoke.py`` captures (seeded weights and frames,
  score threshold 0: SORT's [64, 128] benefits), recorded once by this
  checkout and saved under ``build/``,

as ``a, b, b, a``.

    python experiments/quantize_greedy_paired.py OTHER_CHECKOUT

``OTHER_CHECKOUT`` is a checkout of another commit (``a``); this
repository is ``b``.  Prints one JSON line per run, and the card's name
and power limit.  Times (ms) are device times from ``torch.profiler``:
the quantizer's kernels and memsets summed over a clip's quantizations
(mean of 5 clips), each greedy launch (mean of 20).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENEFITS = os.path.join(REPO, "build", "greedy_benefits.npz")

DUMP = """
import sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
import chip_smoke as c
from tao_amodal_torch.ops import hungarian
from tao_amodal_torch.pipeline import AmodalPipeline
dev = torch.device('cuda', 0)
pipe = AmodalPipeline.create(device=dev).init(
    torch.Generator(device=dev).manual_seed(70))
rs = np.random.RandomState(70)
seen, real = [], hungarian.greedy_fixpoint
def rec(b, *args, **kw):
    seen.append(b.cpu().numpy())
    return real(b, *args, **kw)
rec.launches = 0
hungarian.greedy_fixpoint = rec
state = pipe.init_tracker_state()
for _ in range(3):
    raw = rs.randint(0, 256, (c.T, c.H, c.W, 3), dtype=np.uint8)
    clip, _ = pipe.preprocess(torch.from_numpy(raw).to(dev), out_size=c.S)
    _, state = pipe.streaming(clip, state, score_thr=0.0)
np.savez(sys.argv[1], benefits=np.stack(seen))
"""

RUN = """
import json, sys, numpy as np, torch
sys.path[:0] = ['.', 'tests']
from tao_amodal_torch import _build
from tao_amodal_torch.models import backbones
from tao_amodal_torch.ops import hungarian, int8_conv
_build.build()
_build.library()
dev = torch.device('cuda', 0)


def device_ms(fn, kernels, reps):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if any(k in e.key for k in kernels) and e.device_time_total > 0]
        if ev:
            return sum(e.device_time_total for e in ev) / 1e3 / reps
    raise RuntimeError('the profiler recorded none of ' + str(kernels))


convs = json.loads(sys.argv[2])
shares = hasattr(backbones.ConvBN, 'quantize_input')
rs = np.random.RandomState(0)
inputs, quants = [], []
for i, (stage, hi, wi, cin, cout, ks, stride) in enumerate(convs):
    # A stage's projection follows its first block's last 1x1 (the same
    # Cout) and reads that block's input.
    proj = i >= 4 and ks == 1 and cout == convs[i - 1][4] and (
        cin == convs[i - 3][3])
    if proj:
        x = inputs[i - 3]  # the block's input, its first conv's
    else:
        x = torch.randn((8, hi, wi, cin), device=dev)
        x.view(-1)[int(rs.randint(x.numel()))] = float(rs.uniform(8, 40))
        x = x.permute(0, 3, 1, 2)
    inputs.append(x)
    if not (proj and shares):
        quants.append(x)
names = ('amax_kernel', 'quantize_', 'Memset')  # a barrier's zeroing too
clip = lambda: [int8_conv.quantize_activation_s8(x) for x in quants]
res = {'quantizations': len(quants),
       'quantizer ms a clip': device_ms(clip, names, 5),
       'quantizer ms by input': [device_ms(
           lambda: int8_conv.quantize_activation_s8(x), names, 5)
           for x in inputs]}
del inputs, quants
bs = np.load(sys.argv[1])['benefits']
ms = [device_ms(lambda: hungarian.greedy_fixpoint(b), ('greedy_fixpoint',),
                20) for b in (torch.from_numpy(a).to(dev) for a in bs)]
res['greedy ms by frame'] = ms
res['greedy ms a clip'] = [sum(ms[i:i + 8]) for i in range(0, len(ms), 8)]
print('RESULT ' + json.dumps(res))
"""


def run(cwd, script, *args):
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        sys.exit(f"{cwd} failed:\\n{proc.stderr[-4000:]}")
    return proc.stdout


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path[:0] = [os.path.join(REPO, "tests")]
    from torch_port_fixtures import resnet50_trunk_convs

    trees = {"a": os.path.abspath(sys.argv[1]), "b": REPO}
    os.makedirs(os.path.dirname(BENEFITS), exist_ok=True)
    run(REPO, DUMP, BENEFITS)
    convs = json.dumps(resnet50_trunk_convs())
    for label in "abba":
        for line in run(trees[label], RUN, BENEFITS, convs).splitlines():
            if line.startswith("RESULT "):
                print(f"[{label}] {line[7:]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
