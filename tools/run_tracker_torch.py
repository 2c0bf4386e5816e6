#!/usr/bin/env python
"""Run and evaluate a single-object tracker of the PyTorch port over an
SOT benchmark on the card (same flags as tools/run_tracker.py; --cpu for
the CPU)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.sot_cli import main  # noqa: E402

if __name__ == "__main__":
    main()
