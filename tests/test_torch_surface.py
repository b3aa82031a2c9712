"""The rest of the library surface against puflow_tpu: the affine and
affineEx couplings, the channel index helpers, `hausdorff_distance`,
`jitter_cloud`, the JSD's unit-cube grid and occupancy entropy, and the
encoder's edge features.

Same numpy inputs to both packages. Tolerances: atol 1e-5 on coupling
outputs and 1e-4 on their log-dets (summed over points; as
`tests/test_torch_flows.py` holds the affine injector), integers and
numpy paths exactly, the rest atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.checkpoint import _map_tree
from puflow_torch.eval import jsd as t_jsd
from puflow_torch.flows import coupling as t_coupling
from puflow_torch.flows import permutate as t_permutate
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import encoder as t_encoder
from puflow_torch.ops import chamfer as t_chamfer
from puflow_tpu.eval import jsd as j_jsd
from puflow_tpu.flows import coupling as j_coupling
from puflow_tpu.flows import permutate as j_permutate
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import encoder as j_encoder
from puflow_tpu.ops import chamfer as j_chamfer
from torch_threads import one_torch_thread  # noqa: F401

ATOL, LD_ATOL = 1e-5, 1e-4
B, N, C, CDIM, H = 2, 17, 3, 32, 64


def _mlp(rng, dim_in, dim_out, dim_c=0):
    """A LinearA1D with every layer non-zero (seeded init zeroes w2/b2)."""
    c_in = dim_in + dim_c
    return {
        "w0": (rng.randn(c_in, H) / np.sqrt(c_in)).astype(np.float32),
        "w1": (rng.randn(H, H) / np.sqrt(H)).astype(np.float32),
        "b1": (rng.randn(H) * 0.1).astype(np.float32),
        "w2": (rng.randn(H, dim_out) * 0.2).astype(np.float32),
        "b2": (rng.randn(dim_out) * 0.1).astype(np.float32),
    }


def _t(tree):
    return _map_tree(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                     tree)


def _j(tree):
    return _map_tree(jnp.asarray, tree)


def _data(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    c = (rng.randn(B, N, CDIM) * 0.5).astype(np.float32)
    return rng, x, c


def _check_coupling(name, params, x, c, split):
    fwd_t = getattr(t_coupling, f"{name}_forward")
    inv_t = getattr(t_coupling, f"{name}_inverse")
    fwd_j = getattr(j_coupling, f"{name}_forward")
    inv_j = getattr(j_coupling, f"{name}_inverse")
    tp, jp = _t(params), _j(params)
    zt, ldt = fwd_t(tp, torch.from_numpy(x), torch.from_numpy(c), split)
    zj, ldj = fwd_j(jp, jnp.asarray(x), jnp.asarray(c), split)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=ATOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=LD_ATOL)
    assert np.abs(zt.numpy() - x).max() > 0.1       # the nets move it
    xt, ldi = inv_t(tp, zt, torch.from_numpy(c), split)
    xj, ldij = inv_j(jp, zj, jnp.asarray(c), split)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_allclose(ldi.numpy(), np.asarray(ldij), atol=LD_ATOL)
    np.testing.assert_allclose(xt.numpy(), x, atol=ATOL)
    np.testing.assert_allclose((ldt + ldi).numpy(), 0.0, atol=LD_ATOL)


@pytest.mark.parametrize("split", [1, 2])
def test_affine_coupling_matches_jax_and_inverts(split):
    rng, x, c = _data(split)
    params = {"scale_net": _mlp(rng, split, C - split, CDIM),
              "bias_net": _mlp(rng, split, C - split, CDIM)}
    _check_coupling("affine_coupling", params, x, c, split)


@pytest.mark.parametrize("split", [1, 2])
def test_affine_ex_coupling_matches_jax_and_inverts(split):
    """Scale and bias from the post-update h1 in both directions (the JAX
    package's bijective form), so the inverse is exact."""
    rng, x, c = _data(10 + split)
    params = {"g1": _mlp(rng, C - split, split),
              "g2": _mlp(rng, split, C - split, CDIM),
              "g3": _mlp(rng, split, C - split, CDIM)}
    _check_coupling("affine_ex_coupling", params, x, c, split)


@pytest.mark.parametrize("channel", [1, 3, 8, 33])
def test_index_helpers_match_jax(channel):
    assert (t_permutate.reverse_indices(channel)
            == j_permutate.reverse_indices(channel))
    for seed in (0, 1, 7, 2021):
        idx = t_permutate.random_indices(seed, channel)
        assert idx == j_permutate.random_indices(seed, channel)
        assert all(type(i) is int for i in idx)
        inv = t_permutate.invert_indices(idx)
        assert inv == j_permutate.invert_indices(idx)
        x = torch.arange(channel * 2.0).reshape(2, channel)
        back = t_permutate.reverse_permute(
            t_permutate.reverse_permute(x, idx), inv)
        assert torch.equal(back, x)


def test_hausdorff_distance_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 40, 3).astype(np.float32)
    y = rng.randn(3, 57, 3).astype(np.float32)
    got = t_chamfer.hausdorff_distance(torch.from_numpy(x),
                                       torch.from_numpy(y))
    want = j_chamfer.hausdorff_distance(jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_jitter_cloud_matches_jax_in_distribution():
    """The two packages draw from different generators, so the noise is
    held to JAX's in distribution: both clipped at exactly +-clip, the
    same share of clipped entries and the same spread (4 and 3 standard
    errors at 300,000 draws), and the port's draw fixed by its generator."""
    pc = np.zeros((100, 1000, 3), np.float32)
    sigma, clip = 0.01, 0.015
    got = t_patch.jitter_cloud(torch.Generator().manual_seed(0),
                               torch.from_numpy(pc), sigma, clip).numpy()
    want = np.asarray(j_patch.jitter_cloud(jax.random.PRNGKey(0),
                                           jnp.asarray(pc), sigma, clip))
    again = t_patch.jitter_cloud(torch.Generator().manual_seed(0),
                                 torch.from_numpy(pc), sigma, clip)
    np.testing.assert_array_equal(again.numpy(), got)
    assert got.dtype == np.float32 and got.shape == pc.shape
    for noise in (got, want):
        assert np.abs(noise).max() == np.float32(clip)
    n = pc.size
    share = [np.mean(np.abs(v) == np.float32(clip)) for v in (got, want)]
    p = share[1]
    assert abs(share[0] - p) < 4 * np.sqrt(2 * p * (1 - p) / n)
    std = [v.std() for v in (got, want)]
    assert abs(std[0] - std[1]) < 3 * np.sqrt(2.0 / n) * std[1]
    # the offset is added to the cloud
    shifted = t_patch.jitter_cloud(torch.Generator().manual_seed(0),
                                   torch.from_numpy(pc + 1.0), sigma, clip)
    np.testing.assert_allclose(shifted.numpy() - 1.0, got, atol=1e-6)


@pytest.mark.parametrize("clip_sphere", [False, True])
def test_unit_cube_grid_matches_jax(clip_sphere):
    for res in (2, 5, 28):
        grid, spacing = t_jsd.unit_cube_grid(res, clip_sphere)
        grid_j, spacing_j = j_jsd.unit_cube_grid(res, clip_sphere)
        np.testing.assert_array_equal(grid, grid_j)
        assert spacing == spacing_j


@pytest.mark.parametrize("in_sphere", [False, True])
def test_entropy_of_occupancy_grid_matches_jax(in_sphere):
    rng = np.random.RandomState(5)
    clouds = rng.randn(6, 300, 3).astype(np.float32)
    clouds *= 0.45 / np.linalg.norm(clouds, axis=-1, keepdims=True).max()
    ent, counters = t_jsd.entropy_of_occupancy_grid(clouds, 12, in_sphere)
    ent_j, counters_j = j_jsd.entropy_of_occupancy_grid(clouds, 12, in_sphere)
    assert ent == ent_j
    np.testing.assert_array_equal(counters, counters_j)
    assert counters.sum() == clouds.shape[0] * clouds.shape[1]


def test_edge_features_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 23, 5).astype(np.float32)
    xyz = rng.randn(2, 23, 3).astype(np.float32)
    idx = rng.randint(0, 23, (2, 23, 8))
    got = t_encoder.derive_edge_feat(torch.from_numpy(x),
                                     torch.from_numpy(idx))
    want = j_encoder.derive_edge_feat(jnp.asarray(x), jnp.asarray(idx))
    assert got.shape == (2, 23, 8, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    got = t_encoder.distance_feat(torch.from_numpy(xyz),
                                  torch.from_numpy(idx))
    want = j_encoder.distance_feat(jnp.asarray(xyz), jnp.asarray(idx))
    assert got.shape == (2, 23, 8, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_new_modules_and_smoke_cases_import_no_jax():
    """The modules this surface adds, and the spline cases `chip_smoke.py`
    imports from `tests/`, import neither jax nor `puflow_tpu`."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    mods = ["puflow_torch.flows.spline", "puflow_torch.flows.spline_coupling",
            "puflow_torch.utils.folding", "puflow_torch.utils.permute",
            "puflow_torch.utils.params", "puflow_torch.utils.timers",
            "torch_spline_cases"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'puflow_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(root), str(root / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
