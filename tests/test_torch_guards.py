"""Guards of the port: no jax in `puflow_torch`, no silent CPU fallback,
and the CLI end to end on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch import parallel as t_parallel
from puflow_torch.cli import upsample as t_cli
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import continuous as t_continuous
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import cnf as t_cnf
from puflow_torch.ops import emd as t_emd
from puflow_torch.ops import encoder as t_encoder
from puflow_torch.ops import flow as t_flow
from puflow_torch.ops import fps as t_fps
from puflow_torch.ops import interp as t_interp
from puflow_torch.ops import knn as t_knn
from puflow_torch.utils.device import resolve_device
from puflow_tpu.checkpoint import save_checkpoint
from puflow_tpu.models import continuous as j_continuous
from puflow_tpu.models import discrete as j_discrete
from torch_ckpt_cases import save_reference_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    pkg = ROOT / "puflow_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")


def test_port_imports_no_jax():
    """Every module of the port, and the tests' reference-checkpoint
    writer and data-parallel rank bodies that `chip_smoke.py` shares,
    imports neither jax nor `puflow_tpu`."""
    mods = _port_modules()
    assert {"puflow_torch.cli.evaluate", "puflow_torch.convert.torch_ckpt",
            "puflow_torch.eval.jsd", "puflow_torch.eval.p2f",
            "puflow_torch.eval.uniformity",
            "puflow_torch.ops.approx_match", "puflow_torch.serving",
            "puflow_torch.cli.export",
            "puflow_torch.parallel.mesh"} <= set(mods)
    shared = ["torch_ckpt_cases", "torch_parallel_cases"]
    code = ("import importlib, sys\n"
            f"for m in {mods + shared!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'puflow_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_import_pins_float32_precision():
    """`import puflow_torch` pins exact float32 matmuls and convolutions
    (no TF32), as `import puflow_tpu` pins its matmul precision to
    "highest"; checked in a fresh process that turned TF32 on first."""
    code = ("import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "torch.set_float32_matmul_precision('high')\n"
            "import puflow_torch\n"
            "print(torch.backends.cuda.matmul.allow_tf32,\n"
            "      torch.backends.cudnn.allow_tf32,\n"
            "      torch.get_float32_matmul_precision())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False", "highest"]


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_wrappers_raise_on_other_devices():
    meta = torch.empty((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_fps.farthest_point_sample(meta, 2)
    with pytest.raises(ValueError, match="no kernel"):
        t_fps.farthest_point_sample_seeded(meta, meta, 2)
    with pytest.raises(ValueError, match="no kernel"):
        t_flow.flow_f([], meta, [])
    with pytest.raises(ValueError, match="no kernel"):
        t_flow.flow_g([], torch.empty((1, 8, 3, 4), device="meta"), [])
    idx = torch.empty((1, 8, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_knn.knn_self(meta, 4)
    with pytest.raises(ValueError, match="no kernel"):
        t_encoder.encoder_conditions({}, meta, idx)
    with pytest.raises(ValueError, match="no kernel"):
        t_interp.interp_head({}, meta, idx, 4)
    with pytest.raises(ValueError, match="no kernel"):
        t_flow.flow_g_blend([], meta, torch.empty((1, 8, 8, 4), device="meta"),
                            idx, [])
    with pytest.raises(ValueError, match="no kernel"):
        t_emd.emd_auction(meta, meta)
    cond = torch.empty((1, 8, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_cnf.cnf_solve([], cond, meta, 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        t_cnf.cnf_solve_t([], cond, meta, 0.0, 0.5)


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    ckpt = str(tmp / "model.npz")
    save_checkpoint(ckpt, params, state)
    src = tmp / "in"
    src.mkdir()
    rng = np.random.RandomState(0)
    pts = rng.randn(256, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    np.savetxt(src / "cloud.xyz", pts, fmt="%.6f")
    return tmp, ckpt, src


def test_entry_points_default_to_the_card(cli_inputs):
    """Called without a device, the public entry points ask for CUDA, and
    on a host without a card that raises: the models, the checkpoints,
    the data-parallel group's start and the sharded upsampler."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, ckpt, _ = cli_inputs
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = (jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, state))
    with pytest.raises(RuntimeError, match="cuda"):
        t_discrete.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        t_checkpoint.from_numpy_tree(params, state)
    with pytest.raises(RuntimeError, match="cuda"):
        t_checkpoint.load_checkpoint(ckpt)
    # the data-parallel group starts on cuda:LOCAL_RANK, and the sharded
    # upsampler without a group starts one there
    with pytest.raises(RuntimeError, match="cuda"):
        t_parallel.init_group("gloo", 0, 1)
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        t_patch.upsample_cloud_sharded(model, torch.zeros((2, 64, 3)), 256)
    assert not torch.distributed.is_initialized()


def test_export_entry_points_default_to_the_card(cli_inputs, tmp_path):
    """`serving.export_patch_sampler` and `load_exported` ask for CUDA
    unless told otherwise: without a card they raise, and an artifact made
    on the CPU loads only when the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from puflow_torch import serving as t_serving

    _, ckpt, _ = cli_inputs
    params, state = t_checkpoint.load_checkpoint(ckpt, "cpu",
                                                 fold=True).trees()
    with pytest.raises(RuntimeError, match="cuda"):
        t_serving.export_patch_sampler(params, state)
    with pytest.raises(RuntimeError, match="cuda"):
        t_serving.export_cloud_upsampler(params, state)
    path = str(tmp_path / "sampler.pt2")
    t_serving.save_exported(t_serving.export_patch_sampler(
        params, state, batch=1, patch_size=32, device="cpu"), path)
    with pytest.raises(RuntimeError, match="cuda"):
        t_serving.load_exported(path)
    assert t_serving.load_exported(path, device="cpu").exported is not None


def test_export_cli_exits_nonzero_without_cuda(cli_inputs):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    tmp, ckpt, _ = cli_inputs
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp / "sampler_cuda.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "puflow_torch.cli.export", "--checkpoint",
         ckpt, "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()
    assert not out.exists()


def test_cli_exits_nonzero_without_cuda(cli_inputs):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    tmp, ckpt, src = cli_inputs
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "puflow_torch.cli.upsample", "--source",
         str(src), "--target", str(tmp / "out_cuda"), "--checkpoint", ckpt],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()


def test_evaluate_cli_exits_nonzero_without_cuda(tmp_path):
    """`cli.evaluate` without ``--device`` asks for CUDA and, on a host
    without a card, fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for d in ("gt", "pred"):
        (tmp_path / d).mkdir()
        np.savetxt(tmp_path / d / "a.xyz", np.eye(3), fmt="%.6f")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "puflow_torch.cli.evaluate", "--pred",
         str(tmp_path / "pred"), "--gt", str(tmp_path / "gt"),
         "--save_path", str(tmp_path / "out")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()
    assert not (tmp_path / "out").exists()


def test_cli_upsamples_on_cpu(cli_inputs):
    tmp, ckpt, src = cli_inputs
    out = tmp / "out_cpu"
    t_cli.main(["--source", str(src), "--target", str(out), "--checkpoint",
                ckpt, "--num_patch", "64", "--device", "cpu"])
    lines = (out / "cloud.xyz").read_text().splitlines()
    assert len(lines) == 256 * 4
    assert all(len(v.split(".")[-1]) == 6 for v in lines[0].split())


def test_cnf_entry_points_default_to_the_card(tmp_path):
    """`continuous.init`, `build_model`, `from_numpy_tree(model="cnf")`
    and `load_checkpoint(model="cnf")` ask for CUDA unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    params, state = j_continuous.init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "cnf.npz")
    save_checkpoint(ckpt, params, state)
    params, state = (jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, state))
    with pytest.raises(RuntimeError, match="cuda"):
        t_continuous.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        t_continuous.build_model(torch.Generator().manual_seed(0), 3,
                                 (64, 64), 8, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        t_checkpoint.from_numpy_tree(params, state, model="cnf")
    with pytest.raises(RuntimeError, match="cuda"):
        t_checkpoint.load_checkpoint(ckpt, model="cnf")
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--source", str(tmp_path), "--target",
                    str(tmp_path / "out"), "--checkpoint", ckpt, "--model",
                    "cnf"])


def test_cnf_training_is_not_ported():
    """The three ways into the differentiable CNF solves (the name is from
    before they were ported) run on the CPU with finite gradients; the
    same model asked for on the card raises on a host without one."""
    params, state = t_continuous.init(torch.Generator().manual_seed(0),
                                      device="cpu")
    for p in params["flow_blocks"]:
        p["sqrt_end_time"].requires_grad_()
    ends = [p["sqrt_end_time"] for p in params["flow_blocks"]]
    x = torch.randn((1, 16, 3), generator=torch.Generator().manual_seed(1))
    dense, nll, _ = t_continuous.forward(params, state, x, 4, train=True)
    grads = torch.autograd.grad(nll + torch.mean(dense ** 2), ends)
    assert all(bool(torch.isfinite(g)) for g in grads)
    c = torch.randn((1, 16, 32), generator=torch.Generator().manual_seed(2))
    out = t_continuous.flow_block_inverse(params["flow_blocks"][0], x, c,
                                          differentiable=True)
    (grad,) = torch.autograd.grad(torch.sum(out ** 2), ends[0])
    assert bool(torch.isfinite(grad))
    gen = torch.Generator().manual_seed(3)
    cs = [torch.randn((1, 16, w), generator=gen)
          for w in t_discrete.COND_CHANNELS]
    z, log_det = t_continuous.f_transform(params, x, cs)
    grads = torch.autograd.grad(torch.sum(z ** 2) + log_det.sum(), ends)
    assert all(bool(torch.isfinite(g)) for g in grads)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_continuous.init(torch.Generator().manual_seed(0))


def test_training_kernel_wrappers_guard():
    """The wrappers of the two training kernels raise for a device that is
    neither the CPU nor CUDA, and importing them builds nothing."""
    meta = torch.empty((1, 8, 3), device="meta")
    cond = torch.empty((1, 8, 32), device="meta")
    one = torch.empty((1, 8, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_cnf.cnf_solve_logp([], cond, meta, one, 0.0, 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        t_cnf.cnf_adjoint_bwd([], cond, meta, meta, one, 0.0, 0.5)
    code = ("from puflow_torch.ops import _build\n"
            "def refuse():\n"
            "    raise SystemExit('a kernel was built at import')\n"
            "_build.build = _build.library = refuse\n"
            "import puflow_torch.ops.cnf, puflow_torch.models.continuous\n"
            "print('imported')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "imported"


@pytest.fixture(scope="module")
def cnf_checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cnf_cli")
    params, state = j_continuous.init(jax.random.PRNGKey(0))
    ckpt = str(tmp / "cnf.npz")
    save_checkpoint(ckpt, params, state)
    return ckpt


def _run_cli(src, out, ckpt, *flags):
    t_cli.main(["--source", str(src), "--target", str(out), "--checkpoint",
                ckpt, "--num_patch", "64", "--device", "cpu", *flags])
    return (out / "cloud.xyz").read_text()


@pytest.mark.parametrize("flags", [["--seeded_merge"],
                                   ["--merge_groups", "4"],
                                   ["--model", "cnf", "--seeded_merge"]])
def test_cli_opt_in_merges_on_cpu(cli_inputs, cnf_checkpoint, flags):
    """The opt-in merges end to end: 256 points -> 1,024 written, every
    original among the outputs under the seeded merge."""
    tmp, ckpt, src = cli_inputs
    if "cnf" in flags:
        ckpt = cnf_checkpoint
    out = tmp / ("out_" + "_".join(f.strip("-") for f in flags))
    text = _run_cli(src, out, ckpt, *flags)
    got = np.loadtxt(text.splitlines())
    assert got.shape == (256 * 4, 3) and np.isfinite(got).all()
    if "--seeded_merge" in flags:
        pts = np.loadtxt(src / "cloud.xyz")
        d = ((pts[:, None, :] - got[None, :, :]) ** 2).sum(-1).min(1)
        # originals pass the normalisation round trip and '%.6f'; at most
        # the 24 outliers removed after the merge can be originals
        assert (d < 1e-10).sum() >= 256 - 24


def test_cli_seeded_merge_is_ignored_with_exact(cli_inputs):
    """`--seeded_merge --exact` runs the union merge, as `puflow_tpu`'s CLI
    does: the same file as `--exact` alone."""
    tmp, ckpt, src = cli_inputs
    a = _run_cli(src, tmp / "out_exact", ckpt, "--exact")
    b = _run_cli(src, tmp / "out_exact_seeded", ckpt, "--exact",
                 "--seeded_merge")
    assert a == b


def test_continuous_names_the_cnf_family(cnf_checkpoint):
    """`model="continuous"` loads the CNF family, as in `puflow_tpu`."""
    for fold in (False, True):
        model = t_checkpoint.load_checkpoint(cnf_checkpoint, "cpu", fold=fold,
                                             model="continuous")
        assert isinstance(model, t_continuous.ContinuousModel)
    params, state = j_continuous.init(jax.random.PRNGKey(0))
    params, state = (jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, state))
    model = t_checkpoint.from_numpy_tree(params, state, "cpu",
                                         model="continuous")
    assert isinstance(model, t_continuous.ContinuousModel)
    with pytest.raises(ValueError, match="unknown model family"):
        t_checkpoint.load_checkpoint(cnf_checkpoint, "cpu", model="spline")


def test_pt_checkpoint_raises(cli_inputs):
    """The CLI reads reference `.pt` checkpoints; one of the other family
    raises, naming what the file looks like, and an unknown format
    raises."""
    tmp, _, src = cli_inputs
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    pt = str(tmp / "model.pt")
    save_reference_checkpoint(pt, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state))
    flags = ["--source", str(src), "--target", str(tmp / "x"),
             "--device", "cpu", "--checkpoint"]
    with pytest.raises(ValueError, match="looks like: discrete"):
        t_cli.main([*flags, pt, "--model", "cnf"])
    with pytest.raises(ValueError, match="unrecognised checkpoint format"):
        t_cli.main([*flags, str(tmp / "model.h5")])


def test_trainer_and_train_cli_default_to_the_card(tmp_path):
    """The trainer (either family) and the train CLIs ask for CUDA unless
    told otherwise; on a host without a card that raises before any
    work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from puflow_torch.cli import (train_cnf, train_pu1k, train_pugan,
                                  train_pugeo)
    from puflow_torch.train.trainer import TrainConfig, Trainer

    params, state = t_discrete.init(torch.Generator().manual_seed(0),
                                    device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TrainConfig(), params, state)
    params, state = t_continuous.init(torch.Generator().manual_seed(0),
                                      device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TrainConfig(), params, state,
                forward_fn=t_continuous.forward)
    for cli in (train_pu1k, train_cnf, train_pugan, train_pugeo):
        ckpt = tmp_path / f"{cli.__name__.rsplit('.', 1)[-1]}.npz"
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--synthetic", "1", "--max_epochs", "1",
                      "--checkpoint", str(ckpt)])
        assert not ckpt.exists()
        assert cli.build_parser(cli.DEFAULTS).parse_args([]).device == "cuda"


def test_train_cli_rejects_torch_checkpoints(tmp_path):
    """`--begin_checkpoint` takes reference `.pt` files, and rejects one of
    the other family before training."""
    from puflow_torch.cli import train_pu1k

    params, state = j_continuous.init(jax.random.PRNGKey(0))
    pt = str(tmp_path / "cnf.pt")
    save_reference_checkpoint(pt, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), "cnf")
    with pytest.raises(ValueError, match="looks like: continuous"):
        train_pu1k.main(["--synthetic", "1", "--device", "cpu",
                         "--begin_checkpoint", pt,
                         "--checkpoint", str(tmp_path / "m.npz")])
    assert not (tmp_path / "m.npz").exists()
