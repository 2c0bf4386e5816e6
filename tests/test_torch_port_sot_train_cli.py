"""The port's Siamese train CLI (``tools/train_siamese_torch.py``) on
the CPU: ``--smoke --cpu`` trains and checkpoints, ``--resume`` restores,
and ``--dataset`` refuses a tree without usable sequences.  Its parts
are held against the JAX package in ``test_torch_port_sot_train.py``;
JAX's own CLI trains from Flax's random init, which the port does not
reproduce, so the runs are not compared with JAX's."""

import pytest
import torch

from tao_amodal_torch.cli.train_cli import main as train_main
from torch_port_fixtures import one_torch_thread

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


def test_train_cli_smoke_and_resume(tmp_path):
    """``--smoke --cpu`` trains 2 epochs of 4 steps (checkpoints 1 and 2,
    finite weights, the loss of each logged step finite); ``--resume``
    restores epoch 2's state, which equals the first run's, and trains no
    further; ``--opts`` passes through the config."""
    ck = str(tmp_path / "ck")
    trainer = train_main(["--smoke", "--cpu", "--checkpoint_dir", ck])
    assert trainer.epoch == 2 and sorted(trainer.checkpoints()) == [1, 2]
    saved = {k: v.clone() for k, v in
             trainer.state.model.state_dict().items()}
    assert all(bool(torch.isfinite(v).all()) for v in saved.values()
               if v.is_floating_point())
    again = train_main(["--smoke", "--cpu", "--resume", "--checkpoint_dir",
                        ck, "--opts", "track.penalty_k", "0.1"])
    assert again.epoch == 2
    state = again.state.model.state_dict()
    assert all(torch.equal(state[k], saved[k]) for k in saved)
    assert len(again.state.opt_state) == len(trainer.state.opt_state)


def test_train_cli_refuses_a_tree_without_sequences(tmp_path):
    """``--dataset lasot`` over an empty root exits with a message, as
    JAX's CLI does."""
    with pytest.raises(SystemExit, match="no usable sequences"):
        train_main(["--smoke", "--cpu", "--dataset", "lasot",
                    "--dataset_root", str(tmp_path),
                    "--checkpoint_dir", str(tmp_path / "ck")])
