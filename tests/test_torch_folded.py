"""The port's BN-folded configuration (the upsample CLI's default) against
puflow_tpu.

Parameters: the full-width JAX `discrete.init`, `perturb_init` on the
numpy trees, then each package's own `fold_bn_inference`. Inputs are
numpy-seeded at B=2, n=64, r=4 (8 * 64 = 512 rows, the multiple of 128
that `flow_g_blend_pallas`'s wide index layout needs).

The JAX oracles are the TPU kernels in Pallas interpret mode at exact
precision (`EXACT_PRECISION`, `fast=False`, FLOW_PASSES=3 set and restored
around the flow kernels) and the XLA formulations. Each tolerance is the
JAX package's own bound for that kernel (tests/test_fused_kernels.py),
named beside it with the value measured on a CPU host. The port's side is
the plain version of each kernel: on CPU tensors every wrapper runs it,
and the CUDA kernels are compared with it on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.cli import upsample as t_cli
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import fold_bn as t_fold
from puflow_torch.ops import encoder as t_encoder
from puflow_torch.ops import flow as t_flow
from puflow_torch.ops import interp as t_interp
from puflow_torch.ops import knn as t_knn
from puflow_tpu.checkpoint import _discrete_sample_fn, save_checkpoint
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import fold_bn as j_fold
from puflow_tpu.ops.pallas import encoder_pallas, flow_pallas, knn_pallas
from torch_threads import one_torch_thread  # noqa: F401

B, N, R = 2, 64, 4


@pytest.fixture(scope="module")
def case():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 7)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    tp, ts = t_checkpoint.from_numpy_tree(params, state, "cpu").trees()
    rng = np.random.RandomState(7)
    x = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
    idx = knn_pallas.knn_self_pallas(jnp.asarray(x), 16, True)
    return dict(params=params, state=state, jp=jp, js=js,
                jf=j_fold.fold_bn_inference(jp, js),
                tf=t_fold.fold_bn_inference(tp, ts), x=x,
                xt=torch.from_numpy(x), idx=idx,
                idx_t=torch.tensor(np.asarray(idx)).long(),
                z=rng.randn(B, N, 3).astype(np.float32))


class _FlowPasses3:
    """FLOW_PASSES=3 (exact) around the flow kernels; it is read at trace
    time, so the jit caches are cleared on the way in and out."""

    def __enter__(self):
        self.old = flow_pallas.FLOW_PASSES
        flow_pallas.FLOW_PASSES = 3
        flow_pallas.flow_g_blend_pallas.clear_cache()

    def __exit__(self, *exc):
        flow_pallas.FLOW_PASSES = self.old
        flow_pallas.flow_g_blend_pallas.clear_cache()


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def test_fold_bn_matches_jax(case):
    got, ref = _np(case["tf"]), jax.tree.map(np.asarray, case["jf"])
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    # measured: max leaf difference 6.0e-8 (rsqrt rounding)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6),
                 got, ref)
    # the BN keys are gone; the state keeps its structure with no data
    assert "bn" not in case["tf"]["feat_convs"][0]["convs"][0]
    assert "bn0" not in case["tf"]["interp"]["weight_unit"]
    _, ts = t_checkpoint.from_numpy_tree(case["params"], case["state"],
                                         "cpu").trees()
    empty = t_fold.empty_bn_state(ts)
    assert jax.tree.structure(_np(empty)) == jax.tree.structure(_np(ts))
    assert all(a.numel() == 0 for a in jax.tree.leaves(empty))


@pytest.mark.parametrize("grid", [False, True])
def test_knn_self_plain_matches_jax_kernel(grid):
    rng = np.random.RandomState(11)
    # an integer grid makes every distance exact and forces ties, so the
    # first-occurrence rule is checked slot by slot
    x = (rng.randint(0, 4, (3, 128, 3)) if grid
         else rng.randn(3, 128, 3)).astype(np.float32)
    ref = np.asarray(knn_pallas.knn_self_pallas(jnp.asarray(x), 16, True))
    got = t_knn.knn_self_plain(torch.from_numpy(x), 16).numpy()
    assert got.dtype == np.int64 and got.shape == ref.shape
    if not grid:
        # slot 0 is the point itself; distances ascend
        assert (got[:, :, 0] == np.arange(128)[None]).all()
    d = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    dd = np.take_along_axis(d, got, axis=2)
    assert (np.diff(dd, axis=2) >= 0).all()
    # same sets at both consumer prefixes (test_fused_kernels.py:384-386)
    for kk in (8, 16):
        assert (np.sort(got[..., :kk], -1) == np.sort(ref[..., :kk], -1)).all()
    # both use the delta form and first-occurrence ties: measured equal
    np.testing.assert_array_equal(got, ref)
    before = t_knn.knn_self.launches
    np.testing.assert_array_equal(
        t_knn.knn_self(torch.from_numpy(x), 16).numpy(), got)
    assert t_knn.knn_self.launches == before


def test_encoder_plain_matches_jax(case):
    x, idx = jnp.asarray(case["x"]), case["idx"]
    refs = {
        "kernel": [np.swapaxes(np.asarray(c), 1, 2) for c in
                   encoder_pallas.encoder_conditions_pallas_cm(
                       case["jf"], x, idx, 1, True,
                       encoder_pallas.EXACT_PRECISION)],
        "xla": [np.asarray(c) for c in j_discrete.feat_extract(
            case["jf"], case["js"], x, idx, train=False)[0]],
    }
    got = [c.numpy() for c in t_encoder.encoder_conditions_plain(
        case["tf"], case["xt"], case["idx_t"])]
    for name, ref in refs.items():
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == b.shape
            err, scale = np.abs(a - b).max(), np.abs(b).max()
            # test_fused_kernels.py:54, :84; measured at most 1.4e-6 at a
            # scale of 0.12 against the kernel (relative 1.2e-5) and 3.7e-8
            # against XLA (relative 3.1e-7)
            assert err < 5e-5 * scale + 1e-4, (name, i, err, scale)
    wrapped = t_encoder.encoder_conditions(case["tf"], case["xt"],
                                           case["idx_t"])
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_feat_extract_dispatches_on_folded_params(case):
    """`discrete.feat_extract` sends folded params at inference through the
    `ops.encoder.encoder_conditions` wrapper (on CPU tensors: its plain
    version) and unfolded params through the plain version with BN; both
    give the conditions of JAX's XLA formulation."""
    ref = [np.asarray(c) for c in j_discrete.feat_extract(
        case["jf"], case["js"], jnp.asarray(case["x"]), case["idx"],
        train=False)[0]]
    plain = t_encoder.encoder_conditions_plain(case["tf"], case["xt"],
                                               case["idx_t"])
    calls = []
    wrapper = t_discrete.encoder_conditions

    def spy(*args):
        calls.append(args)
        return wrapper(*args)

    t_discrete.encoder_conditions = spy
    try:
        for state in (None, t_fold.empty_bn_state(
                t_checkpoint.from_numpy_tree(case["params"], case["state"],
                                             "cpu").trees()[1])):
            got, feat_s = t_discrete.feat_extract(case["tf"], state,
                                                  case["xt"], case["idx_t"])
            assert (feat_s is None) == (state is None)
            for a, b, c in zip(got, plain, ref):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
                err, scale = np.abs(a.numpy() - c).max(), np.abs(c).max()
                # the encoder's bound (test_encoder_plain_matches_jax)
                assert err < 5e-5 * scale + 1e-4
        assert len(calls) == 2
        tp, ts = t_checkpoint.from_numpy_tree(case["params"], case["state"],
                                              "cpu").trees()
        unfolded, feat_s = t_discrete.feat_extract(tp, ts, case["xt"],
                                                   case["idx_t"])
        assert len(calls) == 2 and feat_s is ts["feat_convs"]
    finally:
        t_discrete.encoder_conditions = wrapper
    for a, b in zip(unfolded, plain):   # folding keeps the function
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["logits", "weights", "latents"])
def test_interp_head_plain_matches_jax(case, mode):
    ip = case["jf"]["interp"]
    x, idx8 = jnp.asarray(case["x"]), case["idx"][..., :8]
    if mode == "logits":
        ref = np.asarray(encoder_pallas.interp_logits_pallas(
            ip, x, idx8, True, False))
        bound = 2e-3    # test_fused_kernels.py:149; measured 1.3e-6
    elif mode == "weights":
        ref = np.asarray(encoder_pallas.interp_weights_cm_pallas_t(
            ip, x, idx8, R, True, False))                  # [B, r, 8 n]
        ref = ref.reshape(B, R, 8, N).transpose(0, 3, 2, 1)
        bound = 5e-4    # test_fused_kernels.py:125; measured 1.3e-7
    else:
        ref = np.asarray(encoder_pallas.interp_latents_pallas(
            ip, x, idx8, jnp.asarray(case["z"]), R, True, False))
        bound = 5e-4    # test_fused_kernels.py:183; measured 3.2e-6
    z = torch.from_numpy(case["z"])
    got = t_interp.interp_head_plain(case["tf"]["interp"], case["xt"],
                                     case["idx_t"][..., :8], R, mode, z)
    assert got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err < bound, err
    np.testing.assert_array_equal(
        t_interp.interp_head(case["tf"]["interp"], case["xt"],
                             case["idx_t"][..., :8], R, mode, z).numpy(),
        got.numpy())


def _jax_fused_sample(case):
    """The JAX package's fused branch (`discrete.py:311-349`) with every
    kernel in interpret mode at exact precision: returns (conditions
    channel-major, weights, f's latents channel-major, output)."""
    jf, x = case["jf"], jnp.asarray(case["x"])
    idx = knn_pallas.knn_self_pallas(x, 16, True)
    idx8 = idx[..., :8]
    cs = encoder_pallas.encoder_conditions_pallas_cm(
        jf, x, idx, 1, True, encoder_pallas.EXACT_PRECISION)
    ws = encoder_pallas.interp_weights_cm_pallas_t(jf["interp"], x, idx8, R,
                                                   True, False)
    z_cm = flow_pallas.flow_f_pallas(jf["flow_blocks"], x, cs, True, True,
                                     True)
    with _FlowPasses3():
        out = flow_pallas.flow_g_blend_pallas(jf["flow_blocks"], z_cm, ws,
                                              idx8, cs, True, True)
    return cs, ws, z_cm, np.asarray(out)


@pytest.fixture(scope="module")
def jax_fused(case):
    return _jax_fused_sample(case)


def test_flow_g_blend_plain_matches_jax(case, jax_fused):
    cs, ws, z_cm, ref = jax_fused
    t_cs = [torch.from_numpy(np.swapaxes(np.asarray(c), 1, 2).copy())
            for c in cs]
    ws_t = torch.from_numpy(np.asarray(ws).reshape(B, R, 8, N)
                            .transpose(0, 3, 2, 1).copy())
    z = torch.from_numpy(np.swapaxes(np.asarray(z_cm), 1, 2).copy())
    blocks = case["tf"]["flow_blocks"]
    idx8 = case["idx_t"][..., :8]
    got = t_flow.flow_g_blend_plain(blocks, z, ws_t, idx8, t_cs).numpy()
    assert got.shape == (B, N * R, 3)
    # test_fused_kernels.py:347; measured 4.7e-6
    np.testing.assert_allclose(got, ref, atol=3e-5)
    np.testing.assert_array_equal(
        t_flow.flow_g_blend(blocks, z, ws_t, idx8, t_cs).numpy(), got)


def test_folded_sample_matches_jax(case, jax_fused):
    """Whole folded `discrete.sample` against the XLA sample on folded
    params and against the JAX fused composition; atol 1e-4 is the
    whole-`sample` bound of tests/test_torch_model.py (measured 7.7e-7 and
    4.9e-6; the two JAX sides differ by 4.4e-6, and the port's unfolded
    model by 7.9e-7)."""
    ref_xla = np.asarray(j_discrete.sample(case["jf"], case["js"],
                                           jnp.asarray(case["x"]), R))
    got = t_discrete.sample(case["tf"], None, case["xt"], R).numpy()
    assert got.shape == (B, N * R, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_xla, atol=1e-4)
    np.testing.assert_allclose(got, jax_fused[3], atol=1e-4)
    # the unfolded model gives the same function
    tp, ts = t_checkpoint.from_numpy_tree(case["params"], case["state"],
                                          "cpu").trees()
    unfolded = t_discrete.sample(tp, ts, case["xt"], R).numpy()
    np.testing.assert_allclose(got, unfolded, atol=1e-4)


def _chamfer(a, b):
    d = ((a[0][:, None, :] - b[0][None, :, :]) ** 2).sum(-1)
    return d.min(1).mean() + d.min(0).mean()


def test_folded_pipeline_matches_jax():
    """`upsample_cloud` + `remove_outliers` on the 512-point test cloud,
    folded: against JAX's folded pipeline, CD < 1.5e-3
    (tests/test_pipeline_parity.py:177-199; measured 8.6e-11), and against
    the port's own unfolded pipeline, CD < 1e-4 (measured 3.5e-14)."""
    n, patch, outliers = 512, 64, 24
    npoint = n * R + outliers
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 3)
    rng = np.random.RandomState(0)
    pts = rng.randn(1, n, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    jp, js = jax.tree.map(jnp.asarray, (params, state))
    cloud = jnp.asarray(pts)
    ref = j_patch.upsample_cloud((j_fold.fold_bn_inference(jp, js), js),
                                 cloud, _discrete_sample_fn, npoint, R, patch,
                                 4.0, None, False, 0)
    ref = np.asarray(j_patch.remove_outliers(ref, cloud, outliers))

    pc = torch.from_numpy(pts)
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    tp, ts = model.trees()
    folded = t_discrete.DiscreteModel(t_fold.fold_bn_inference(tp, ts),
                                      t_fold.empty_bn_state(ts))
    outs = []
    for m in (folded, model):
        out = t_patch.upsample_cloud(m, pc, npoint, R, patch, 4.0)
        outs.append(t_patch.remove_outliers(out, pc, outliers).numpy())
    got, unfolded = outs
    assert got.shape == ref.shape == (1, n * R, 3)
    assert np.isfinite(got).all()
    assert _chamfer(got, ref) < 1.5e-3
    assert _chamfer(got, unfolded) < 1e-4


@pytest.mark.parametrize("exact", [False, True])
def test_cli_folds_unless_exact(tmp_path, monkeypatch, exact):
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "model.npz")
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
                "--checkpoint", ckpt, "--num_patch", "32", "--device", "cpu"]
               + (["--exact"] if exact else []))
    first_conv = loaded[0].trees()[0]["feat_convs"][0]["convs"][0]
    assert ("bn" in first_conv) == exact
    assert len((tmp_path / "out" / "cloud.xyz").read_text().splitlines()) \
        == 128 * R
