#!/usr/bin/env python
"""Train the PyTorch port's Siamese RPN tracker on the card (same flags
as tools/train_siamese.py; --cpu for the CPU, --smoke for a small
synthetic run)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.train_cli import main  # noqa: E402

if __name__ == "__main__":
    main()
