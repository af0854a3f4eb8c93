"""The port's training CLI (``python -m paddlexde_tpu_torch.examples.train_d3stn``)
on the CPU: one main and one finetune epoch on the synthetic data at its
smallest length (2 days: the shortest that gives the validation and test
splits a window after the 288-step history), finite test metrics, the
checkpoint written; ``--distribute`` refused."""

import math

import pytest
import torch

from paddlexde_tpu_torch.examples.train_d3stn import main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch compute thread per worker (the suite runs 6 workers on 8
    cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_cli_trains_and_tests_on_synthetic_data(tmp_path):
    results = main(["--synthetic", "--train_epochs", "1", "--finetune_epochs", "1",
                    "--seq_days", "2", "--batch_size", "64", "--device", "cpu",
                    "--save_dir", str(tmp_path)])
    assert all(math.isfinite(results[k]) for k in ("mae", "rmse", "mape", "smis"))
    assert len(results["per_horizon"]) == 12
    assert list(tmp_path.glob("SYNTH/*/epoch_best.params"))
    with pytest.raises(NotImplementedError, match="item 10"):
        main(["--synthetic", "--distribute", "--device", "cpu"])
