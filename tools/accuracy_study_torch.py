#!/usr/bin/env python
"""Run the PyTorch port's accuracy study (train -> serve -> Track-mAP) on
the card (same flags as tools/accuracy_study.py; --cpu for the CPU)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.accuracy_study import main  # noqa: E402

if __name__ == "__main__":
    main()
