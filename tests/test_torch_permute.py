"""The point-order utilities and the folding net against puflow_tpu.

The numpy utilities are exactly equal to JAX's (they are a copy); the
folding net's apply is held at atol 1e-5, twenty training steps from the
same initial parameters at 1e-4 on the parameters and 1e-5 relative on
the loss; a folding `.npz` written by either package gives the same
permutation through the other's `PermutateHelper` (atol 1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.checkpoint import _map_tree
from puflow_torch.ops.chamfer import chamfer_distance
from puflow_torch.utils import folding as t_folding
from puflow_torch.utils import permute as t_permute
from puflow_tpu.utils import folding as j_folding
from puflow_tpu.utils import permute as j_permute
from torch_threads import one_torch_thread  # noqa: F401


def _cloud(seed, b=2, n=100, scale=0.99):
    rng = np.random.RandomState(seed)
    return ((rng.rand(b, n, 3).astype(np.float32) - 0.5) * scale)


@pytest.mark.parametrize("method", ["distance", "nearest"])
@pytest.mark.parametrize("n_grid", [None, 4, 16])
def test_permute_by_grid_is_jax(method, n_grid):
    pts = _cloud(0)
    for ret in (False, True):
        got = t_permute.permute_by_grid(pts, method, n_grid, ret)
        want = j_permute.permute_by_grid(pts, method, n_grid, ret)
        np.testing.assert_array_equal(got, want)
    # the 2-D image-grid branch
    img = np.random.RandomState(1).uniform(-1, 1, (2, 50, 2))
    np.testing.assert_array_equal(
        t_permute.permute_by_grid(img, method, n_grid, True),
        j_permute.permute_by_grid(img, method, n_grid, True))


def test_matching_is_jax():
    rng = np.random.RandomState(2)
    lr = (rng.rand(2, 8, 3).astype(np.float32) - 0.5) * 1.8
    sr = (rng.rand(2, 32, 3).astype(np.float32) - 0.5) * 1.8
    np.testing.assert_array_equal(t_permute.lr_hr_matching(lr, sr, 4),
                                  j_permute.lr_hr_matching(lr, sr, 4))
    for fn in ("permute_by_matching", "permute_by_matching2"):
        for ret in (False, True):
            got = getattr(t_permute, fn)(lr, sr, 4, is_return_idx=ret)
            want = getattr(j_permute, fn)(lr, sr, 4, is_return_idx=ret)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_permute_by_folding_is_jax():
    """A hand-built folding function: the reference's index algebra."""
    rng = np.random.RandomState(5)
    pts = rng.rand(2, 20, 3).astype(np.float32)
    ref = rng.rand(2, 7, 3).astype(np.float32)
    got = t_permute.permute_by_folding(pts, lambda p: ref)
    want = j_permute.permute_by_folding(pts, lambda p: ref)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.sort(got.ravel()), np.sort(pts.ravel()))


def test_helper_grid_mode_is_jax():
    pts = _cloud(3, 1, 64, 1.9)
    for mode in (None, ("distance", 16), ("nearest", 8)):
        h_t, h_j = t_permute.PermutateHelper(), j_permute.PermutateHelper()
        if mode is not None:
            h_t.permutebygrid(*mode)
            h_j.permutebygrid(*mode)
        np.testing.assert_array_equal(h_t.permute(pts), h_j.permute(pts))


def _jax_params(seed):
    return jax.tree.map(np.asarray,
                        j_folding.folding_net_init(jax.random.PRNGKey(seed)))


def _to_torch(params):
    return _map_tree(lambda a: torch.tensor(np.asarray(a, np.float32)),
                     params)


def _plane(seed, n=128):
    """One simple cloud: points on a plane patch (JAX's test)."""
    uv = np.random.RandomState(seed).rand(1, n, 2).astype(np.float32) * 2 - 1
    return np.concatenate([uv, 0.1 * uv[..., :1]], axis=-1)


def test_folding_net_apply_matches_jax():
    params = _jax_params(0)
    pts = _cloud(4, 3, 50)
    got = t_folding.folding_net_apply(_to_torch(params), torch.from_numpy(pts))
    want = j_folding.folding_net_apply(_map_tree(jnp.asarray, params),
                                       jnp.asarray(pts))
    assert got.shape == (3, t_folding.sample_grid_count(), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert t_folding.sample_grid_count() == j_folding.sample_grid_count()
    assert (t_folding.count_parameters(_to_torch(params))
            == j_folding.count_parameters(params))


def test_folding_init_matches_jax_layout():
    got = t_folding.folding_net_init(torch.Generator().manual_seed(0),
                                     device="cpu")
    shapes = _map_tree(lambda t: tuple(t.shape), got)
    assert shapes == _map_tree(lambda a: tuple(a.shape), _jax_params(0))
    assert not any(layer["b"].any() for layers in got.values()
                   for layer in layers)
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            t_folding.folding_net_init(torch.Generator())


def test_train_folding_net_matches_jax():
    """Twenty SGD-with-momentum steps from JAX's initial parameters."""
    clouds = _plane(6)
    want, want_loss = j_folding.train_folding_net(jax.random.PRNGKey(0),
                                                  clouds, steps=20, lr=3e-3)
    got, loss = t_folding.train_folding_net(
        None, clouds, steps=20, lr=3e-3, device="cpu",
        params=_to_torch(_jax_params(0)))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    flat_got = jax.tree.leaves(_map_tree(lambda t: t.numpy(), got))
    flat_want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    for a, b in zip(flat_got, flat_want, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_folding_net_trains_and_helper_roundtrips(tmp_path):
    """JAX's test on the port: 150 steps lower the chamfer loss; the
    reference points do not depend on the input's point order; a helper
    loaded from the saved `.npz` permutes as the in-memory function."""
    clouds = _plane(6)
    gen = torch.Generator().manual_seed(0)
    params, loss = t_folding.train_folding_net(gen, clouds, steps=150,
                                               lr=3e-3, device="cpu")
    init = t_folding.folding_net_init(torch.Generator().manual_seed(0),
                                      device="cpu")
    x = torch.from_numpy(clouds)
    init_loss = float(chamfer_distance(t_folding.folding_net_apply(init, x),
                                       x))
    assert loss < init_loss

    perm = np.random.RandomState(6).permutation(clouds.shape[1])
    ref_a = t_folding.folding_net_apply(params, x)
    ref_b = t_folding.folding_net_apply(params, x[:, perm])
    np.testing.assert_allclose(ref_a.numpy(), ref_b.numpy(), atol=1e-5)

    path = str(tmp_path / "folding.npz")
    t_permute.save_folding_params(path, params)
    h = t_permute.PermutateHelper()
    h.permutebyfolding(path, device="cpu")
    out = h.permute(clouds)
    np.testing.assert_allclose(np.sort(out.ravel()), np.sort(clouds.ravel()),
                               atol=1e-6)
    h2 = t_permute.PermutateHelper()
    h2.permutebyfolding(t_permute.bind_folding(params))
    np.testing.assert_allclose(out, h2.permute(clouds), atol=1e-6)


def test_folding_npz_is_shared_with_jax(tmp_path):
    """A file written by either package permutes the same through both
    packages' helpers."""
    params = _jax_params(3)
    clouds = _cloud(7, 2, 90)
    j_path = str(tmp_path / "jax.npz")
    t_path = str(tmp_path / "torch.npz")
    j_permute.save_folding_params(j_path, params)
    t_permute.save_folding_params(t_path, _to_torch(params))
    for path in (j_path, t_path):
        h_t, h_j = t_permute.PermutateHelper(), j_permute.PermutateHelper()
        h_t.permutebyfolding(path, device="cpu")
        h_j.permutebyfolding(path)
        np.testing.assert_allclose(h_t.permute(clouds), h_j.permute(clouds),
                                   atol=1e-6)
    # the in-memory callables of both packages agree too
    h_j = j_permute.PermutateHelper()
    h_j.permutebyfolding(functools.partial(
        j_folding.folding_net_apply, _map_tree(jnp.asarray, params)))
    h_t = t_permute.PermutateHelper()
    h_t.permutebyfolding(t_permute.bind_folding(_to_torch(params)))
    np.testing.assert_allclose(h_t.permute(clouds), h_j.permute(clouds),
                               atol=1e-6)
    with np.load(t_path) as f, np.load(j_path) as g:
        assert sorted(f.files) == sorted(g.files)
