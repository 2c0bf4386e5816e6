#!/usr/bin/env python
"""Stress the PyTorch port's evaluators at the reference's scale (same
flags as tools/stress_eval.py but --with_reference; --device_eval on the
card, --cpu for the CPU)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.stress_eval import main  # noqa: E402

if __name__ == "__main__":
    main()
