#!/usr/bin/env python
"""Run the PyTorch port of the detect+expand+track pipeline over a
dataset and write the evaluator-ready prediction JSON (same flags as
tools/run_pipeline.py; add --device to pick the card)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.infer_cli import main  # noqa: E402

if __name__ == "__main__":
    main()
