#!/usr/bin/env python
"""SiamRPN hyperparameter sweep of the PyTorch port: the whole grid of
(penalty_k, window_influence, lr) tracks each sequence as one batch on
the card (same flags as tools/hp_search.py; --cpu for the CPU).

    python tools/hp_search_torch.py --dataset otb --dataset_root DIR \
        --penalty_k 0.02,0.04,0.08 --window_influence 0.3,0.44,0.6 \
        --lr 0.25,0.4,0.55 [--checkpoint siamese.npz]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from tao_amodal_torch.cli.sot_cli import sweep_main  # noqa: E402

if __name__ == "__main__":
    sweep_main()
