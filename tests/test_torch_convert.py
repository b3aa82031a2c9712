"""The port's reference `.pt` converter against `puflow_tpu`'s on the same
files: seeded `puflow_tpu` parameters written in the reference's
`state_dict` keys (`tests/torch_ckpt_cases.py`) convert to bit-equal
trees in both packages, and the port serves and trains from them."""

import jax
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.cli import train_pu1k as t_train_pu1k
from puflow_torch.convert import torch_ckpt as t_convert
from puflow_torch.inference.patch import remove_outliers, upsample_cloud
from puflow_torch.train import trainer as t_trainer
from puflow_tpu.convert import torch_ckpt as j_convert
from puflow_tpu.models import continuous as j_continuous
from puflow_tpu.models import discrete as j_discrete
from torch_ckpt_cases import (REFERENCE_NUMBERS, reference_state_dict,
                              save_reference_checkpoint)
from torch_threads import one_torch_thread  # noqa: F401

INITS = {"discrete": j_discrete.init, "cnf": j_continuous.init}
T_LOADERS = {"discrete": t_convert.load_discrete_checkpoint,
             "cnf": t_convert.load_cnf_checkpoint}
J_LOADERS = {"discrete": j_convert.load_discrete_checkpoint,
             "cnf": j_convert.load_cnf_checkpoint}
OTHER = {"discrete": "cnf", "cnf": "discrete"}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_bit_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(x, y), key


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """family -> (.pt path, .npz path, numpy (params, state)) of seeded
    `puflow_tpu` parameters."""
    tmp = tmp_path_factory.mktemp("convert")
    files = {}
    for family, init in INITS.items():
        trees = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
        pt, npz = tmp / f"{family}.pt", tmp / f"{family}.npz"
        save_reference_checkpoint(str(pt), *trees, family)
        t_checkpoint.save_checkpoint(str(npz), *trees)
        files[family] = (str(pt), str(npz), trees)
    return files


@pytest.mark.parametrize("family", ["discrete", "cnf"])
def test_converters_agree_and_round_trip(reference_files, family):
    """Both packages' converters give bit-equal trees, equal to the trees
    written; the file holds the reference checkpoint's count of numbers."""
    pt, _, written = reference_files[family]
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    assert sum(v.numel() for v in sd.values()) == REFERENCE_NUMBERS[family]
    ours = T_LOADERS[family](pt)
    assert_trees_bit_equal(ours, J_LOADERS[family](pt))
    assert_trees_bit_equal(ours, written)
    assert_trees_bit_equal(t_checkpoint.load_numpy_checkpoint(pt, family),
                           written)


@pytest.mark.parametrize("family", ["discrete", "cnf"])
def test_wrong_family_names_the_kind(reference_files, family):
    """A checkpoint read as the other family raises ValueError in both
    packages, with the same message naming what the file looks like."""
    pt = reference_files[family][0]
    with pytest.raises(ValueError, match="looks like") as ours:
        T_LOADERS[OTHER[family]](pt)
    with pytest.raises(ValueError, match="looks like") as theirs:
        J_LOADERS[OTHER[family]](pt)
    assert str(ours.value) == str(theirs.value)
    kind = "discrete" if family == "discrete" else "continuous (CNF)"
    assert f"looks like: {kind}" in str(ours.value)


def test_permutation_other_than_reverse_raises(reference_files, tmp_path):
    params, state = reference_files["discrete"][2]
    path = str(tmp_path / "perm.pt")
    save_reference_checkpoint(path, params, state, permutation=(0, 2, 1))
    for loader in (t_convert.load_discrete_checkpoint,
                   j_convert.load_discrete_checkpoint):
        with pytest.raises(ValueError, match="unexpected permutation"):
            loader(path)


def test_state_dict_layouts(reference_files):
    """Linear weights are written [out, in], 1x1 convs [out, in, 1, 1]."""
    params, state = reference_files["discrete"][2]
    sd = reference_state_dict(params, state)
    w = params["merge_convs"][0]["conv1"]["w"]
    assert tuple(sd["merge_convs.0.conv1.weight"].shape) == w.shape[::-1]
    conv = params["feat_convs"][0]["conv_out"]["w"]
    assert tuple(sd["feat_convs.0.conv_out.weight"].shape) == (
        conv.shape[1], conv.shape[0], 1, 1)


@pytest.mark.parametrize("family", ["discrete", "cnf"])
def test_pt_checkpoint_serves_like_npz(reference_files, family):
    """`load_checkpoint(x.pt, fold=True)` serves a small cloud through
    `upsample_cloud` bit-equal to the same trees' `.npz`."""
    pt, npz, _ = reference_files[family]
    pc = torch.from_numpy(np.random.RandomState(1).randn(1, 128, 3)
                          .astype(np.float32))
    outs = []
    for path in (pt, npz):
        model = t_checkpoint.load_checkpoint(path, "cpu", fold=True,
                                             model=family)
        with torch.no_grad():
            out = upsample_cloud(model, pc, 128 * 4 + 24, 4, 64)
            outs.append(remove_outliers(out, pc, 24))
    assert outs[0].shape == (1, 128 * 4, 3)
    assert torch.equal(outs[0], outs[1])


def test_train_cli_begins_from_a_pt(reference_files, tmp_path, monkeypatch):
    """`train_pu1k --begin_checkpoint x.pt` starts from the converted
    parameters: the trainer's first flat vectors equal theirs."""
    pt = reference_files["discrete"][0]
    first = []

    class Recording(t_trainer.Trainer):
        def __init__(self, cfg, params, bn_state, **kw):
            super().__init__(cfg, params, bn_state, **kw)
            first.append((self.params.clone(), self.bn_state.clone()))

    monkeypatch.setattr(t_trainer, "Trainer", Recording)
    tr = t_train_pu1k.main(["--synthetic", "1", "--max_epochs", "1",
                            "--batch_size", "1", "--val_batches", "1",
                            "--device", "cpu", "--begin_checkpoint", pt,
                            "--checkpoint", str(tmp_path / "m.npz")])
    assert isinstance(tr, Recording) and len(first) == 1
    params, state = t_convert.load_discrete_checkpoint(pt)
    cpu = torch.device("cpu")
    want_p = t_trainer.TreeLayout(params).flatten(params, cpu)
    want_s = t_trainer.TreeLayout(state).flatten(state, cpu)
    assert torch.equal(first[0][0], want_p)
    assert torch.equal(first[0][1], want_s)
    assert (tmp_path / "m-epoch1.npz").exists()
