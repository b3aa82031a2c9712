"""The port's `torch.export` serving artifacts against the live port and
against `puflow_tpu` (tests/test_serving.py's sizes and gates).

Parameters: the full-width JAX `discrete.init`, `perturb_init` on the
numpy trees (flows away from the identity, BN away from the identity so
that folding matters), then each package's own `fold_bn_inference`. The
port exports on the CPU, where every ``torch.ops.puflow.*`` op runs its
kernel's plain version; the same ops launch the CUDA kernels in an
artifact exported on the card (chip_smoke.py's export phase).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch import serving as t_serving
from puflow_torch.cli import export as t_export_cli
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import continuous as t_cont
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import fold_bn as t_fold
from puflow_tpu.checkpoint import _discrete_sample_fn, save_checkpoint
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import fold_bn as j_fold
from torch_cnf_cases import N as CNF_N
from torch_cnf_cases import R as CNF_R
from torch_cnf_cases import case  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

R = 4
# the folded discrete path's kernels: one op call each in its graph
FOLDED_OPS = {"knn_self": 1, "encoder": 1, "interp_head": 1, "flow_f": 1,
              "flow_g_blend": 1}


@pytest.fixture(scope="module")
def trees():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 5)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    tp, ts = t_checkpoint.from_numpy_tree(params, state, "cpu").trees()
    return {False: dict(jax=(jp, js), port=(tp, ts)),
            True: dict(jax=(j_fold.fold_bn_inference(jp, js), js),
                       port=(t_fold.fold_bn_inference(tp, ts),
                             t_fold.empty_bn_state(ts))),
            "numpy": (params, state)}


def _patches(b, n=256, seed=3):
    pts = np.random.RandomState(seed).randn(b, n, 3)
    return (pts / (np.linalg.norm(pts, axis=-1, keepdims=True) + 1.0)
            ).astype(np.float32)


def _round_trip(ep, path):
    t_serving.save_exported(ep, str(path))
    return t_serving.load_exported(str(path), device="cpu")


def puflow_calls(ep) -> collections.Counter:
    """``puflow::`` op calls in the exported graph and every submodule's
    (`torch.no_grad` bodies sit in a `wrap_with_set_grad_enabled`
    submodule)."""
    calls = collections.Counter()
    for mod in ep.graph_module.modules():
        for node in mod.graph.nodes:
            target = getattr(node.target, "name", lambda: "")()
            if node.op == "call_function" and target.startswith("puflow::"):
                calls[target.split("::")[1].split(".")[0]] += 1
    return calls


def _chamfer(a, b) -> float:
    """Largest per-cloud symmetric Chamfer (mean squared NN distance both
    ways)."""
    d = ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)
    return float((d.min(2).mean(1) + d.min(1).mean(1)).max())


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("batch", [4, None])
def test_patch_sampler_roundtrip(tmp_path, trees, folded, batch):
    """Through a saved and reloaded `.pt2`: equal to the live `sample` at
    JAX's gate (atol 1e-6, tests/test_serving.py:38) and within 1e-4 of
    `puflow_tpu`'s `discrete.sample` (tests/test_torch_folded.py:261)."""
    (tp, ts), (jp, js) = trees[folded]["port"], trees[folded]["jax"]
    ep = t_serving.export_patch_sampler(tp, ts, batch=batch, upratio=R,
                                        device="cpu")
    fn = _round_trip(ep, tmp_path / "sampler.pt2")
    assert fn.exported is not None and not fn.exported.constants
    for b in ((4,) if batch else (1, 5)):
        x = _patches(b)
        got = fn(torch.from_numpy(x)).numpy()
        assert got.shape == (b, 256 * R, 3)
        live = t_discrete.sample(tp, ts, torch.from_numpy(x), R).numpy()
        np.testing.assert_allclose(got, live, atol=1e-6)
        ref = np.asarray(j_discrete.sample(jp, js, jnp.asarray(x), R))
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_folded_graph_holds_one_op_per_kernel(trees):
    """The folded sampler's graph calls each kernel of the path once, as
    an opaque op: export captured the kernels, not their plain versions
    (whose FPS-free path would show as aten ops and no puflow call)."""
    tp, ts = trees[True]["port"]
    ep = t_serving.export_patch_sampler(tp, ts, batch=None, device="cpu")
    assert puflow_calls(ep) == FOLDED_OPS
    # the unfolded model keeps its encoder, k-NN and head as tensor ops
    up, us = trees[False]["port"]
    ep = t_serving.export_patch_sampler(up, us, batch=None, device="cpu")
    assert puflow_calls(ep) == {"flow_f": 1, "flow_g": 1}


def test_cloud_upsampler_roundtrip(tmp_path, trees):
    """B=2 clouds of 512 points through the whole folded pipeline: the
    artifact is deterministic, Chamfer < 5e-5 to the live `upsample_cloud`
    (tests/test_serving.py:101) and < 1.5e-3 to `puflow_tpu`'s
    (tests/test_torch_folded.py:285-319)."""
    B, N = 2, 512
    (tp, ts), (jp, js) = trees[True]["port"], trees[True]["jax"]
    ep = t_serving.export_cloud_upsampler(tp, ts, cloud_points=N, upratio=R,
                                          batch=B, device="cpu")
    assert puflow_calls(ep) == dict(FOLDED_OPS, fps=2)
    fn = _round_trip(ep, tmp_path / "cloud.pt2")
    pts = _patches(B, N, seed=4)
    out = fn(torch.from_numpy(pts)).numpy()
    assert out.shape == (B, N * R + 24, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, fn(torch.from_numpy(pts)).numpy())
    model = t_discrete.DiscreteModel(tp, ts)
    live = t_patch.upsample_cloud(model, torch.from_numpy(pts), N * R + 24,
                                  R).numpy()
    assert _chamfer(out, live) < 5e-5
    ref = np.asarray(j_patch.upsample_cloud((jp, js), jnp.asarray(pts),
                                            _discrete_sample_fn, N * R + 24,
                                            R, 256, 4.0))
    assert _chamfer(out, ref) < 1.5e-3


def test_export_cli(tmp_path, trees):
    """The CLI on a `.npz`: BN folded as it serves, a symbolic batch by
    default; the cloud kind wants a concrete batch."""
    params, state = trees["numpy"]
    ckpt = str(tmp_path / "m.npz")
    save_checkpoint(ckpt, params, state)
    out = str(tmp_path / "sampler.pt2")
    t_export_cli.main(["--checkpoint", ckpt, "--out", out, "--device",
                       "cpu"])
    fn = t_serving.load_exported(out, device="cpu")
    x = torch.from_numpy(_patches(3))
    tp, ts = trees[True]["port"]
    np.testing.assert_allclose(fn(x).numpy(),
                               t_discrete.sample(tp, ts, x, R).numpy(),
                               atol=1e-6)
    with pytest.raises(SystemExit, match="concrete --batch"):
        t_export_cli.main(["--checkpoint", ckpt, "--out", out, "--kind",
                           "cloud", "--device", "cpu"])
    cloud = str(tmp_path / "cloud.pt2")
    t_export_cli.main(["--checkpoint", ckpt, "--out", cloud, "--kind",
                       "cloud", "--batch", "1", "--cloud_points", "256",
                       "--device", "cpu"])
    ep = t_serving.load_exported(cloud, device="cpu").exported
    assert puflow_calls(ep) == dict(FOLDED_OPS, fps=2)


def test_cnf_patch_sampler_matches_jax(tmp_path, case):  # noqa: F811
    """The folded CNF sampler, symbolic batch, at tests/test_cnf.py's small
    sizes: its graph calls the solve 12 times, the encoder and the head
    once; through the file it equals the live `continuous.sample` (atol
    1e-6) and is within 1e-4 of `puflow_tpu`'s (the gate of
    tests/test_torch_cnf_model.py:69)."""
    tf, ts = case["tf"], t_fold.empty_bn_state(case["ts"])
    ep = t_serving.export_patch_sampler(tf, ts, model="cnf", upratio=CNF_R,
                                        patch_size=CNF_N, device="cpu")
    assert puflow_calls(ep) == {"cnf_solve": 12, "encoder": 1,
                                "interp_head": 1}
    fn = _round_trip(ep, tmp_path / "cnf.pt2")
    got = fn(case["xt"]).numpy()
    live = t_cont.sample(tf, ts, case["xt"], CNF_R).numpy()
    np.testing.assert_allclose(got, live, atol=1e-6)
    ref = np.asarray(j_cont.sample(case["jf"], case["js"],
                                   jnp.asarray(case["x"]), CNF_R))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # one patch: a solve's step size is shared by the batch's rows, so
    # against the live sample of that patch alone
    one = case["xt"][:1]
    np.testing.assert_allclose(fn(one).numpy(),
                               t_cont.sample(tf, ts, one, CNF_R).numpy(),
                               atol=1e-6)
