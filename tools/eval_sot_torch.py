#!/usr/bin/env python
"""Evaluate written SOT trajectories with the PyTorch port's evaluators
(the same dataset flags as tools/run_tracker_torch.py; implies
--eval_only)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.sot_cli import main  # noqa: E402

if __name__ == "__main__":
    main(["--eval_only"] + sys.argv[1:])
