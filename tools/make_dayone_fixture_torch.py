#!/usr/bin/env python
"""Write the day-one TAO-Amodal tree from synthetic videos with the PyTorch
port (same flags as tools/make_dayone_fixture.py)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.data.dayone_fixture import main  # noqa: E402

if __name__ == "__main__":
    main()
