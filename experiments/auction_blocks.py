"""The auction's host-check block on one card: SORT over the detections
of the full-width pipeline that ``chip_smoke.py`` drives (seeded weights
and frames, unfused, score threshold 0, so all 64 detections of a frame
are valid; two clips, the state threaded), through
``sort_scan(impl="auto")``, with ``ops/hungarian.py::AUCTION_BLOCK`` set
to each of several block sizes, for the gated and the full auction, and
greedy as the yardstick.  Every block must give the same integers (a
round past the last active row is a no-op).

    python experiments/auction_blocks.py [BLOCK ...]    # default 2 4 8 16

Each (assignment, block) is timed as ms a clip (host clock, synchronized)
over 2 clips, 3 passes in turns (the order reversed every other pass).
Prints the rounds a frame the auctions need (host count), one line per
(assignment, block) and the card's name and power limit.
"""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(blocks):
    import torch

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import chip_smoke as c
    from tao_amodal_torch.ops import hungarian, sort_scan
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.trackers import sort
    from tao_amodal_torch.trackers.sort import init_sort
    from torch_port_fixtures import auction_fixpoint

    if not torch.cuda.is_available():
        sys.exit("auction_blocks: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = AmodalPipeline.create(device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    rs = np.random.RandomState(3)
    state, dets = pipe.init_tracker_state(), []
    for _ in range(2):
        raw = rs.randint(0, 256, (c.T, c.H, c.W, 3), dtype=np.uint8)
        clip, _ = pipe.preprocess(torch.from_numpy(raw).to(dev),
                                  out_size=c.S)
        out, state = pipe.streaming(clip, state, score_thr=0.0)
        dets.append((out["visible_boxes"], out["scores"] > 0.0))
    kw = dict(max_age=pipe.sort_max_age, min_hits=pipe.sort_min_hits)

    def run(assignment):
        st, ids, ms = init_sort(c.SORT_K, device=dev), [], []
        for boxes, valid in dets:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, (i, _) = sort_scan.sort_scan(st, boxes, valid,
                                             assignment=assignment, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ids.append(i)
        return torch.stack(ids), ms

    seen, real = [], hungarian.auction_assign

    def record(benefit, *args, **kwargs):
        seen.append((benefit.cpu().numpy(), args, kwargs))
        return real(benefit, *args, **kwargs)

    sort.auction_assign = record
    want = {}
    try:
        for assignment in ("gated_auction", "auction"):
            seen.clear()
            want[assignment] = run(assignment)[0]
            rounds = [auction_fixpoint(b, *a, **k)[1] for b, a, k in seen]
            print(f"{assignment}: rounds a frame {rounds}, total "
                  f"{sum(rounds)}", flush=True)
    finally:
        sort.auction_assign = real
    want["greedy"] = run("greedy")[0]

    cases = [("greedy", None)] + [(a, b) for a in ("gated_auction", "auction")
                                  for b in blocks]
    times = {case: [] for case in cases}
    for p in range(3):
        for assignment, block in (cases if p % 2 == 0 else cases[::-1]):
            if block is not None:
                hungarian.AUCTION_BLOCK = block
            ids, ms = run(assignment)
            if not torch.equal(ids, want[assignment]):
                sys.exit(f"auction_blocks: {assignment} with block {block} "
                         f"gives other track ids")
            times[(assignment, block)] += ms
    for (assignment, block), ms in times.items():
        print(f"{assignment} block {block}: ms a clip "
              f"{', '.join(f'{m:.2f}' for m in ms)}; median "
              f"{np.median(ms):.2f}, mean {np.mean(ms):.2f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main([int(b) for b in sys.argv[1:]] or [2, 4, 8, 16])
