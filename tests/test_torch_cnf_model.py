"""The port's whole CNF model against puflow_tpu on the CPU: init and
checkpoint trees, `continuous.sample`, `f_transform` / `g_transform`, the
whole-cloud pipeline and the upsample CLI.

Whole-model cases use `discrete.perturb_init`, which gives the CNF layers'
time rows a large scale: a seeded field hardly depends on t and every solve
would take the controller's minimum of three steps. With it the solves
take 4 to 8 steps with some rejected, and at these seeds and shapes both
frameworks take the same accept / reject sequence.

The parameters come from the JAX package as numpy trees and go through
`from_numpy_tree` or plain `torch.tensor`; inputs are numpy-seeded. The
shared cases are in tests/torch_cnf_cases.py; tests/test_torch_cnf*.py
split the CNF family's tests by what they hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.cli import upsample as t_cli
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import continuous as t_cont
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import fold_bn as t_fold
from puflow_torch.ops.knn import knn_indices as t_knn_indices
from puflow_tpu.checkpoint import _cnf_sample_fn, save_checkpoint
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.models import fold_bn as j_fold

from torch_cnf_cases import B, KEY, N, R, case  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------
# whole model
# --------------------------------------------------------------------------
def test_init_and_checkpoint_trees_match_jax(case, tmp_path):
    tp, ts = t_cont.init(torch.Generator().manual_seed(0), device="cpu")
    got = jax.tree.map(np.asarray, (tp, ts))
    ref = (case["params"], case["state"])
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert isinstance(case["model"], t_cont.ContinuousModel)
    assert "params.flow_blocks.0.sqrt_end_time" in case["model"].state_dict()
    # numpy trees -> model -> numpy trees -> .npz -> model, unchanged
    back = t_checkpoint.to_numpy_tree(case["model"])
    path = str(tmp_path / "cnf.npz")
    t_checkpoint.save_checkpoint(path, *back)
    loaded = t_checkpoint.load_checkpoint(path, "cpu", model="cnf")
    assert isinstance(loaded, t_cont.ContinuousModel)
    for a, b, c in zip(jax.tree.leaves(back), jax.tree.leaves(ref),
                       jax.tree.leaves(t_checkpoint.to_numpy_tree(loaded))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    folded = t_checkpoint.load_checkpoint(path, "cpu", fold=True, model="cnf")
    assert isinstance(folded, t_cont.ContinuousModel)
    assert t_discrete.is_folded(folded.trees()[0])
    with pytest.raises(ValueError, match="unknown model family"):
        t_checkpoint.load_checkpoint(path, "cpu", model="glow")


@pytest.mark.parametrize("folded", [False, True])
def test_sample_matches_jax(case, folded):
    """Whole `continuous.sample`, 12 block-solves: atol 1e-4, the bound of
    the discrete `sample` (tests/test_torch_model.py). Measured 8.0e-6
    unfolded and 7.7e-6 folded."""
    jp = case["jf"] if folded else case["jp"]
    ref = np.asarray(j_cont.sample(jp, case["js"], jnp.asarray(case["x"]), R))
    if folded:
        got = t_cont.sample(case["tf"], None, case["xt"], R).numpy()
        via_module = t_cont.ContinuousModel(
            case["tf"], t_fold.empty_bn_state(case["ts"]))(case["xt"], R)
    else:
        got = t_cont.sample(case["tp"], case["ts"], case["xt"], R).numpy()
        via_module = case["model"](case["xt"], R)
    assert got.shape == (B, N * R, 3) and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    print(f"continuous.sample folded={folded}: max_abs_err {err:.3e}")
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(via_module.numpy(), got)


def test_f_g_transform_match_jax(case):
    x, jx = case["xt"], jnp.asarray(case["x"])
    idx = t_knn_indices(x, x, 16)
    cs, _ = t_discrete.feat_extract(case["tp"], case["ts"], x, idx)
    jcs = [jnp.asarray(c.numpy()) for c in cs]
    rz, _ = j_cont.f_transform(case["jp"], jx, jcs, differentiable=False,
                               need_logp=False)
    gz, gld = t_cont.f_transform(case["tp"], x, cs, differentiable=False,
                                 need_logp=False)
    np.testing.assert_allclose(gz.numpy(), np.asarray(rz), atol=1e-5)
    assert float(gld.abs().max()) == 0.0
    fz = np.random.RandomState(11).randn(B, N, 3, R).astype(np.float32) * 0.5
    rg = j_cont.g_transform(case["jp"], jnp.asarray(fz), jcs, R)
    gg = t_cont.g_transform(case["tp"], torch.from_numpy(fz), cs, R)
    assert gg.shape == (B, N * R, 3)
    np.testing.assert_allclose(gg.numpy(), np.asarray(rg), atol=1e-5)
    with pytest.raises(ValueError, match="samples"):
        t_cont.g_transform(case["tp"], torch.from_numpy(fz), cs, 2)


def _chamfer(a, b):
    d = ((a[0][:, None, :] - b[0][None, :, :]) ** 2).sum(-1)
    return d.min(1).mean() + d.min(0).mean()


def test_cnf_pipeline_matches_jax():
    """`upsample_cloud` + `remove_outliers` on the 512-point test cloud of
    tests/test_torch_pipeline.py through the CNF model, BN folded (the
    CLI's default): Chamfer to the JAX pipeline below 1.5e-3, the repo's
    pipeline gate (tests/test_pipeline_parity.py:177-199); measured
    7.1e-12."""
    n, patch, outliers = 512, 64, 24
    npoint = n * R + outliers
    params, state = j_cont.init(KEY)
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 3)
    rng = np.random.RandomState(0)
    pts = rng.randn(1, n, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    jp, js = jax.tree.map(jnp.asarray, (params, state))
    cloud = jnp.asarray(pts)
    ref = j_patch.upsample_cloud((j_fold.fold_bn_inference(jp, js), js),
                                 cloud, _cnf_sample_fn, npoint, R, patch,
                                 4.0, None, False, 0)
    ref = np.asarray(j_patch.remove_outliers(ref, cloud, outliers))

    model = t_checkpoint.from_numpy_tree(params, state, "cpu", model="cnf")
    tp, ts = model.trees()
    folded = t_cont.ContinuousModel(t_fold.fold_bn_inference(tp, ts),
                                    t_fold.empty_bn_state(ts))
    pc = torch.from_numpy(pts)
    got = t_patch.upsample_cloud(folded, pc, npoint, R, patch, 4.0)
    got = t_patch.remove_outliers(got, pc, outliers).numpy()
    assert got.shape == ref.shape == (1, n * R, 3)
    assert np.isfinite(got).all()
    cd = _chamfer(got, ref)
    print(f"CNF pipeline vs JAX: CD {cd:.3e}")
    assert cd < 1.5e-3


@pytest.mark.parametrize("exact", [False, True])
def test_cli_upsamples_with_the_cnf_model(tmp_path, monkeypatch, exact):
    params, state = j_cont.init(KEY)
    ckpt = str(tmp_path / "cnf.npz")
    save_checkpoint(ckpt, params, state)
    src = tmp_path / "in"
    src.mkdir()
    pts = np.random.RandomState(0).randn(128, 3)
    np.savetxt(src / "cloud.xyz", pts, fmt="%.6f")

    loaded = []
    load = t_checkpoint.load_checkpoint

    def spy(*args, **kwargs):
        loaded.append(load(*args, **kwargs))
        return loaded[-1]

    monkeypatch.setattr(t_checkpoint, "load_checkpoint", spy)
    t_cli.main(["--source", str(src), "--target", str(tmp_path / "out"),
                "--checkpoint", ckpt, "--num_patch", "32", "--model", "cnf",
                "--device", "cpu"] + (["--exact"] if exact else []))
    assert isinstance(loaded[0], t_cont.ContinuousModel)
    assert t_discrete.is_folded(loaded[0].trees()[0]) != exact
    lines = (tmp_path / "out" / "cloud.xyz").read_text().splitlines()
    assert len(lines) == 128 * R
    assert np.isfinite(np.loadtxt(tmp_path / "out" / "cloud.xyz")).all()
