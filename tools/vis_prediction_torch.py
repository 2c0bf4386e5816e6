#!/usr/bin/env python
"""Render prediction videos of the PyTorch port (same flags as
tools/vis_prediction.py), drawn in numpy on the host."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.vis_cli import main  # noqa: E402

if __name__ == "__main__":
    main(mode="prediction")
