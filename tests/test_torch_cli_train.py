"""The port's train CLIs on the CPU (`--device cpu`): `train_cnf`,
`train_pugan` and `train_pugeo` each train one small epoch and save their
checkpoints; the CNF checkpoint then serves through the folded CNF model.
"""

import numpy as np
import pytest
import torch

from puflow_torch import checkpoint
from puflow_torch.cli import train_cnf, train_pu1k, train_pugan, train_pugeo
from puflow_torch.data import pugeo, tfrecord
from puflow_torch.inference.patch import remove_outliers, upsample_cloud
from puflow_torch.models import continuous, discrete
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def warmups(monkeypatch):
    """Counts the calls of `discrete.actnorm_warmup`."""
    calls = []
    warmup = discrete.actnorm_warmup

    def counted(*args, **kw):
        calls.append(1)
        return warmup(*args, **kw)

    monkeypatch.setattr(discrete, "actnorm_warmup", counted)
    return calls


def _flags(tmp_path, name, *extra):
    return ["--max_epochs", "1", "--batch_size", "1", "--val_batches", "1",
            "--device", "cpu", "--checkpoint", str(tmp_path / f"{name}.npz"),
            *extra]


def test_train_cnf_trains_and_its_checkpoint_serves(tmp_path, warmups):
    """One synthetic epoch of the CNF family: no ActNorm warm-up, no
    chamfer term; the checkpoint it saves loads as the folded CNF model
    and upsamples a cloud."""
    tr = train_cnf.main(_flags(tmp_path, "cnf", "--synthetic", "1"))
    assert warmups == []
    assert tr.forward_fn is continuous.forward
    assert tr.cfg.cd_weight == 0.0 and tr.cfg.learning_rate == 1e-3
    assert len(tr.history) == 1 and tr.history[0]["nan_step"] == 0.0
    assert np.isfinite(tr.history[0]["vloss"])
    ckpt = tmp_path / "cnf-epoch1.npz"
    assert (tmp_path / "cnf.npz").exists() and ckpt.exists()
    model = checkpoint.load_checkpoint(str(ckpt), "cpu", fold=True,
                                       model="cnf")
    assert isinstance(model, continuous.ContinuousModel)
    pc = torch.from_numpy(np.random.RandomState(0).randn(1, 256, 3)
                          .astype(np.float32))
    with torch.no_grad():
        out = upsample_cloud(model, pc, 256 * 4 + 24, 4, 64)
        out = remove_outliers(out, pc, 24)
    assert out.shape == (1, 256 * 4, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("cli,cd_weight,lr", [(train_pugan, 1e-1, 1e-4),
                                              (train_pu1k, 0.0, 1e-3)])
def test_discrete_train_clis_weigh_the_chamfer_term(tmp_path, warmups, cli,
                                                    cd_weight, lr):
    """PU-GAN trains with the chamfer term at 1e-1 and Adam at 1e-4, PU1K
    without it; both warm ActNorm up once and save their checkpoints."""
    tr = cli.main(_flags(tmp_path, "m", "--synthetic", "1"))
    assert warmups == [1]
    assert tr.forward_fn is discrete.forward
    assert tr.cfg.cd_weight == cd_weight and tr.cfg.learning_rate == lr
    assert len(tr.history) == 1 and tr.history[0]["nan_step"] == 0.0
    assert (tmp_path / "m-epoch1.npz").exists()


def test_train_pugan_defaults():
    args = train_pugan.build_parser(train_pugan.DEFAULTS).parse_args([])
    assert (args.learning_rate, args.max_epochs, args.device) == (
        1e-4, 300, "cuda")
    assert args.data.endswith("PUGAN_poisson_256_poisson_1024.h5")


def _pugeo_shards(tmp_path):
    """Shards at the default resolutions (5,000 and 20,000 points a shape),
    written by the port's codec -> their glob."""
    rng = np.random.RandomState(2)
    payloads = []
    for _ in range(2):
        lo = rng.rand(5000, 3).astype(np.float32)
        hi = np.repeat(lo, 4, axis=0) + 0.01 * rng.randn(20000, 3).astype(
            np.float32)
        payloads.append(tfrecord.build_example_floats(
            {"res_5000": lo.ravel(), "res_20000": hi.ravel()}))
    shards = tmp_path / "shards"
    shards.mkdir()
    tfrecord.write_records(
        str(shards / "res_5000_res_20000_p256_0.tfrecord"), payloads)
    return str(shards / "*.tfrecord")


def test_train_pugeo_trains_on_tfrecord_shards(tmp_path, warmups,
                                               monkeypatch):
    """The CLI's loaders give 300 batches an epoch of 256 -> 1,024-point
    k-NN patches; the CLI trains on them and saves its checkpoints (here
    on the first 3 batches of the epoch: 300 steps of the discrete model
    take minutes on one CPU thread)."""
    records = _pugeo_shards(tmp_path)
    args = train_pugeo.build_parser(train_pugeo.DEFAULTS).parse_args(
        ["--data", records, "--batch_size", "1", "--val_batches", "1"])
    train_iter, val_iter = train_pugeo._loaders(args)
    shapes = {(sp.shape, de.shape) for sp, de in train_iter()}
    assert shapes == {((1, 256, 3), (1, 1024, 3))}
    assert sum(1 for _ in train_iter()) == 300
    assert sum(1 for _ in val_iter()) == 1

    loaders = pugeo.make_loaders
    monkeypatch.setattr(pugeo, "make_loaders",
                        lambda cfg: loaders({**cfg, "num_batches": 3}))
    tr = train_pugeo.main(_flags(tmp_path, "pugeo", "--data", records))
    assert warmups == [1]
    assert tr.cfg.cd_weight == 0.0
    assert tr.history[0]["steps"] == 3
    assert tr.history[0]["nan_step"] == 0.0
    assert (tmp_path / "pugeo-epoch1.npz").exists()
