#!/usr/bin/env python
"""Run the PyTorch port's scale rehearsal (the day-one tree, the inference
CLI, the evaluation CLI) on the card (same flags as
tools/scale_rehearsal.py; --cpu for the CPU)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.scale_rehearsal import main  # noqa: E402

if __name__ == "__main__":
    main()
