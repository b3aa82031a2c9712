"""The train CLI under torchrun on the CPU: two `gloo` ranks of
`python -m torch.distributed.run -m puflow_torch.cli.train_pu1k` train
data parallel and rank 0 alone writes the checkpoints, whose weights are
those of the same two ranks' `Trainer` run in process
(`torch_parallel_cases.cli_twin_rank`)."""

import os
import subprocess
import sys
from pathlib import Path

from puflow_torch.checkpoint import load_npz_checkpoint
from torch_parallel_cases import cli_twin_rank, run_ranks
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import _assert_trees_close

ROOT = Path(__file__).resolve().parent.parent


def test_train_cli_under_torchrun_writes_rank0s_weights(tmp_path):
    ckpt = tmp_path / "ck" / "m.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "puflow_torch.cli.train_pu1k",
         "--device", "cpu", "--dist_backend", "gloo", "--synthetic", "2",
         "--batch_size", "2", "--max_epochs", "1", "--val_batches", "1",
         "--checkpoint", str(ckpt)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    # rank 0 alone logs and saves: one epoch line, one final save
    assert proc.stdout.count("[epoch   0]") == 1, proc.stdout
    assert proc.stdout.count("Model saved to") == 1, proc.stdout
    assert sorted(os.listdir(ckpt.parent)) == ["m-epoch1.npz", "m.npz"]

    params, state = load_npz_checkpoint(str(tmp_path / "ck" / "m-epoch1.npz"))
    ranks = run_ranks(cli_twin_rank, 2, 2021, 2, 2, tmp=tmp_path)
    for want_p, want_s in ranks:
        _assert_trees_close(params, want_p, atol=0)
        _assert_trees_close(state, want_s, atol=0)
