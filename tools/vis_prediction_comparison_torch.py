#!/usr/bin/env python
"""Side-by-side videos of two prediction sets, drawn by the PyTorch port
(same flags as tools/vis_prediction_comparison.py; pass --prediction and
--prediction2)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.vis_cli import main  # noqa: E402

if __name__ == "__main__":
    main(mode="comparison")
