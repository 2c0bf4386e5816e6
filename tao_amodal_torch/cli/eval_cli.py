"""TAO-Amodal evaluation CLI (PyTorch port).

Port of :mod:`tao_amodal_tpu.cli.eval_cli`, flag- and log-compatible with
the reference ``tools/eval_on_tao_amodal.py``: same arguments
(``--track_result --output_log --annotation``), same metric set, the same
``copypaste:`` machine-greppable lines, and the same small-table summary
(reference ``eval_on_tao_amodal.py:68-151``).  Without ``--device_eval``
the float64 host evaluators score; with it the device evaluators run on
``--device`` (default ``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from tao_amodal_torch.data.results import make_track_ids_unique
from tao_amodal_torch.evaluation import (
    AmodalDetectionEvaluator,
    DeviceDetectionEval,
    DeviceTrackEval,
    TrackMapEvaluator,
)

DETECTION_METRICS = [
    "AP", "AP50", "AP75",
    "AP-HO", "AP50-HO", "AP75-HO",
    "AP-PO", "AP50-PO", "AP75-PO",
    "AP-HV", "AP50-HV", "AP75-HV",
    "AP-OOF", "AP50-OOF", "AP75-OOF",
    "AP-HP", "AP50-HP", "AP75-HP", "APr", "APc", "APf",
]


def create_small_table(small_dict):
    """detectron2-style one-row pipe table of float values.

    Renders what ``tabulate([values], headers=keys, tablefmt="pipe",
    floatfmt=".3f", stralign="center", numalign="center")`` renders (the
    reference CLI's dependency), without it: a column is as wide as its
    value or its header plus 2, whichever is wider, cells are centered
    with the odd space on the right, and one space pads each side.
    """
    keys = list(small_dict)
    values = [format(float(small_dict[k]), ".3f") for k in keys]
    widths = [max(len(k) + 2, len(v)) for k, v in zip(keys, values)]

    def line(cells):
        return "|" + "|".join(f" {c:^{w}} " for c, w in zip(cells, widths)) \
            + "|"

    rule = "|" + "|".join(":" + "-" * w + ":" for w in widths) + "|"
    return "\n".join([line(keys), rule, line(values)])


def default_arg_parser():
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0] if __doc__ else "",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--track_result", type=str, required=True)
    parser.add_argument("--output_log", type=str, required=True)
    parser.add_argument("--annotation", type=str, default=None)
    parser.add_argument(
        "--device_eval", action="store_true",
        help="run the batched device evaluators (DeviceTrackEval /"
             " DeviceDetectionEval) on --device instead of the host path."
             " Tolerance contract: the device computes IoU in float32"
             " (host: float64) — metrics are bit-identical unless a"
             " match IoU lies within ~1 f32 ulp (6e-8 relative) of an"
             " eval threshold, where the comparison can flip; drift is"
             " bounded by that flip fraction"
             " (tests/test_device_tolerance.py quantifies both cases)")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of --device_eval (e.g. cuda, cuda:1, cpu)")
    return parser


def evaluate_detection(annotation, track_result, iou_type, logger,
                       device=None):
    """Amodal detection AP block (reference CLI :68-116); ``device``
    None runs the host evaluator."""
    logger.info("Evaluating {} on LVIS...".format(track_result))
    if device is not None:
        lvis_eval = DeviceDetectionEval(annotation, track_result,
                                        iou_type, device=device)
    else:
        lvis_eval = AmodalDetectionEvaluator(annotation, track_result,
                                             iou_type)
    lvis_eval.run()
    lvis_eval.print_results()

    results = lvis_eval.get_results()
    results = {m: float(results[m] * 100) for m in DETECTION_METRICS}

    logger.info("Evaluation results for {}: \n".format(iou_type)
                + create_small_table(results))
    important = [(m, results[m]) for m in DETECTION_METRICS]
    logger.info("copypaste: " + ",".join(k[0] for k in important))
    logger.info("copypaste: "
                + ",".join("{0:.4f}".format(k[1]) for k in important))
    return results


def evaluate_tracking(annotation, results_path, logger, device=None):
    """Track-mAP block (reference CLI :118-151); ``device`` None runs
    the host evaluator."""
    logger.setLevel(logging.INFO)
    results = {}
    logger.info("Loading gt {}...".format(annotation))
    logger.info("Loading results...")
    with open(results_path, "r") as f:
        result_anns = json.load(f)
    make_track_ids_unique(result_anns)
    logger.info("Building")
    if device is not None:
        tao_eval = DeviceTrackEval(annotation, result_anns, logger=logger,
                                   device=device)
    else:
        tao_eval = TrackMapEvaluator(annotation, result_anns,
                                     logger=logger)
    logger.info("Done")
    tao_eval.run()
    tao_eval.print_results()
    r = tao_eval.get_results()
    results["TAO 3DmAP50"] = r["AP50"] * 100
    results["TAO 3DmAP50-HP"] = r["AP50-HP"] * 100
    results["TAO 3DmAP"] = r["AP"] * 100
    results["TAO 3DmAP-HP"] = r["AP-HP"] * 100
    logger.info("TAO 3DmAP50:{:.4f}".format(results["TAO 3DmAP50"]))
    logger.info("TAO 3DmAP50-HP:{:.4f}".format(results["TAO 3DmAP50-HP"]))
    logger.info("TAO 3DmAP:{:.4f}".format(results["TAO 3DmAP"]))
    logger.info("TAO 3DmAP-HP:{:.4f}".format(results["TAO 3DmAP-HP"]))
    keys = ["TAO 3DmAP50", "TAO 3DmAP50-HP", "TAO 3DmAP", "TAO 3DmAP-HP"]
    logger.info("copypaste: " + ",".join(keys))
    logger.info("copypaste: "
                + ",".join("{:.4f}".format(results[k]) for k in keys))
    return results


def main(argv=None):
    args = default_arg_parser().parse_args(argv)
    annotation = args.annotation
    if annotation is None:
        raise SystemExit("--annotation is required (no cluster default "
                         "path in this build)")
    device = args.device if args.device_eval else None
    output_log = Path(args.output_log)

    logger = logging.getLogger(__name__)
    logger.setLevel(logging.INFO)
    output_log.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(output_log, mode="w")
    logger.addHandler(handler)
    try:
        det = evaluate_detection(annotation, args.track_result, "bbox",
                                 logger=logger, device=device)
        trk = evaluate_tracking(annotation, args.track_result, logger,
                                device=device)
    finally:
        logger.removeHandler(handler)
        handler.close()
    return det, trk


if __name__ == "__main__":
    main()
