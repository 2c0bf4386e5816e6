#!/usr/bin/env python
"""Evaluate TAO-Amodal tracking predictions (detection AP + Track-mAP)
with the PyTorch port: same flags as tools/eval_on_tao_amodal.py, plus
--device for --device_eval (default cuda).

    python tools/eval_on_tao_amodal_torch.py \
        --track_result lvis_instances_results.json \
        --output_log eval.log \
        --annotation validation_lvis_v1.json [--device_eval]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.eval_cli import main  # noqa: E402

if __name__ == "__main__":
    main()
