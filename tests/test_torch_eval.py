"""The port's evaluation protocol against `puflow_tpu` on the same numpy
inputs: approx-match EMD, JSD, uniformity, `load_off`, the p2f tool's
wrapper and the `evaluate` CLI.

Tolerances. The approx-match EMD agrees to 1e-5 relative: the two
packages' squared distances are bit-equal on these inputs, and the sums
of the annealing rounds differ in order only (measured 3.7e-7 at most).
The plan is held elementwise to 1e-4 absolute (entries up to 1):
``exp(-16384 d2)`` magnifies each sum's rounding, and both float32 plans
lie up to 1.1e-4 from the port's float64 plan (the port's 3.6e-5 /
1.3e-5 / 1.1e-4 / 7.0e-5, JAX's 3.2e-5 / 1.3e-5 / 1.1e-4 / 7.0e-5 at the
four shapes below, measured on the CPU); the port's plan is also held to
be no farther from the float64 plan than twice JAX's. CD and HD are each
the sum of two reductions of `chamfer_parts`, which `tests/test_torch_ops.py`
holds to JAX at 1e-6 absolute: 2e-6 absolute (measured 2.4e-7; 1.5e-5 of
an HD of 0.016, where a 1e-5 relative gate fails). JSD, P2F and
uniformity are numpy (or the same native tool) in both packages: equal.
"""

import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.cli import evaluate as t_evaluate
from puflow_torch.eval import jsd as t_jsd
from puflow_torch.eval import p2f as t_p2f
from puflow_torch.eval import uniformity as t_uniformity
from puflow_torch.ops import approx_match as t_am
from puflow_torch.utils.io import load_off as t_load_off
from puflow_tpu.cli import evaluate as j_evaluate
from puflow_tpu.eval import jsd as j_jsd
from puflow_tpu.eval import p2f as j_p2f
from puflow_tpu.eval import uniformity as j_uniformity
from puflow_tpu.ops import approx_match as j_am
from puflow_tpu.utils.io import load_off as j_load_off
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_fixtures import icosphere, save_off  # noqa: E402

EMD_RTOL = 1e-5
PLAN_ATOL = 1e-4
CHAMFER_ATOL = 2e-6

CUBE_OFF = """OFF
8 12 0
0 0 0
1 0 0
1 1 0
0 1 0
0 0 1
1 0 1
1 1 1
0 1 1
3 0 1 2
3 0 2 3
3 4 6 5
3 4 7 6
3 0 5 1
3 0 4 5
3 1 5 6
3 1 6 2
3 2 6 7
3 2 7 3
3 3 7 4
3 3 4 0
"""
# counts on the magic's line, a quad and a pentagon (fan-triangulated)
POLY_OFF = """OFF 6 2 0
0 0 0
1 0 0
1 1 0
0 1 0
0.5 1.5 0
-0.5 0.5 0
4 0 1 2 3
5 3 2 4 5 0
"""

SHAPES = [((2, 64, 3), (2, 64, 3)), ((1, 48, 3), (1, 48, 3)),
          ((1, 64, 3), (1, 256, 3)), ((1, 256, 3), (1, 64, 3))]


def _clouds(shape1, shape2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape1).astype(np.float32),
            rng.rand(*shape2).astype(np.float32))


@pytest.mark.parametrize("shape1,shape2", SHAPES)
def test_approx_match_matches_jax(shape1, shape2):
    x, y = _clouds(shape1, shape2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    plan_t = t_am.approx_match(tx, ty).numpy()
    plan_j = np.asarray(j_am.approx_match(jx, jy))
    plan_64 = t_am.approx_match(tx.double(), ty.double()).numpy()
    assert plan_t.shape == (shape1[0], shape1[1], shape2[1])
    np.testing.assert_allclose(plan_t, plan_j, rtol=0, atol=PLAN_ATOL)
    off_t = np.abs(plan_t - plan_64).max()
    off_j = np.abs(plan_j - plan_64).max()
    assert off_t <= 2 * off_j + 1e-6, (off_t, off_j)

    cost_t = t_am.match_cost(tx, ty, torch.from_numpy(plan_j)).numpy()
    cost_j = np.asarray(j_am.match_cost(jx, jy, jnp.asarray(plan_j)))
    np.testing.assert_allclose(cost_t, cost_j, rtol=EMD_RTOL)
    emd_t = float(t_am.earth_mover(tx, ty))
    emd_j = float(j_am.earth_mover(jx, jy))
    assert abs(emd_t - emd_j) <= EMD_RTOL * abs(emd_j), (emd_t, emd_j)


def test_earth_mover_is_match_cost_of_the_plan():
    """`earth_mover` reuses the plan's distances for the cost: the same
    value as `match_cost` of `approx_match`, bit for bit."""
    x, y = (torch.from_numpy(a) for a in _clouds((2, 64, 3), (2, 80, 3)))
    plan = t_am.approx_match(x, y)
    want = torch.mean(t_am.match_cost(x, y, plan) / 64)
    assert torch.equal(t_am.earth_mover(x, y), want)


def test_jsd_matches_jax():
    rng = np.random.RandomState(4)
    a = (rng.rand(3, 256, 3) - 0.5).astype(np.float32) * 0.8
    b = (rng.rand(3, 256, 3) - 0.5).astype(np.float32) * 0.6
    for resolution in (28, 16):
        got = t_jsd.jsd_between_point_cloud_sets(a, b, resolution)
        assert got == j_jsd.jsd_between_point_cloud_sets(a, b, resolution)
        assert got > 0


@pytest.mark.parametrize("text", [CUBE_OFF, POLY_OFF], ids=["cube", "poly"])
def test_load_off_matches_jax(tmp_path, text):
    path = tmp_path / "m.off"
    path.write_text(text)
    verts, faces = t_load_off(str(path))
    j_verts, j_faces = j_load_off(str(path))
    assert verts.dtype == j_verts.dtype and faces.dtype == j_faces.dtype
    assert np.array_equal(verts, j_verts) and np.array_equal(faces, j_faces)
    if text is POLY_OFF:
        assert faces.tolist() == [[0, 1, 2], [0, 2, 3], [3, 2, 4],
                                  [3, 4, 5], [3, 5, 0]]


SIDE_FILES = ("_point2mesh_distance.xyz", "_point2mesh_distance.txt",
              "_disk_idx.txt", "_radius.txt")


def _p2f_both(tmp_path, mesh, pts, **kw):
    """The same prediction through both packages' `run_p2f`, each in a
    folder of its own -> ((avg, std), folder) for the port, then JAX."""
    out = []
    for name, mod in (("torch", t_p2f), ("jax", j_p2f)):
        d = tmp_path / name
        d.mkdir()
        pred = d / "pred.xyz"
        np.savetxt(pred, pts, fmt="%.6f")
        out.append((mod.run_p2f(str(mesh), str(pred), **kw), d))
    return out


def test_p2f_matches_jax_on_the_cube(tmp_path):
    mesh = tmp_path / "cube.off"
    mesh.write_text(CUBE_OFF)
    pts = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.0], [2.0, 0.5, 0.5],
                    [0.5, 0.5, 1.25], [1.5, 1.5, 1.5]])
    (ours, d_t), (theirs, d_j) = _p2f_both(tmp_path, mesh, pts)
    assert ours == theirs
    np.testing.assert_allclose(ours[0], np.mean([0.5, 0.0, 1.0, 0.25,
                                                 np.sqrt(3) / 2]), atol=1e-6)
    assert ((d_t / "pred_point2mesh_distance.xyz").read_bytes()
            == (d_j / "pred_point2mesh_distance.xyz").read_bytes())
    assert Path(t_p2f.ensure_built()).parent == t_p2f.BUILD_DIR


def test_p2f_uniform_matches_jax_and_feeds_analyze_uniform(tmp_path):
    """`--uniform` on an icosphere(3): the same statistics and side-files as
    JAX's `run_p2f`, and `analyze_uniform` of both packages equal on them."""
    verts, faces = icosphere(3)
    mesh = tmp_path / "s.off"
    save_off(str(mesh), verts, faces)
    rng = np.random.RandomState(0)
    pts = rng.normal(size=(600, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    (ours, d_t), (theirs, d_j) = _p2f_both(tmp_path, mesh, pts,
                                           uniform=True, seed=3,
                                           samples=100)
    assert ours == theirs
    for suffix in SIDE_FILES:
        assert ((d_t / f"pred{suffix}").read_bytes()
                == (d_j / f"pred{suffix}").read_bytes()), suffix
    args = (str(d_t / "pred_disk_idx.txt"), str(d_t / "pred_radius.txt"),
            str(d_t / "pred_point2mesh_distance.txt"))
    measure = t_uniformity.analyze_uniform(*args)
    assert measure.shape == (5, 1) and np.isfinite(measure).all()
    assert np.array_equal(measure, j_uniformity.analyze_uniform(*args))
    assert np.array_equal(t_uniformity.PERCENTAGES, j_uniformity.PERCENTAGES)


def test_p2f_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's message, and so does a
    host without g++: the tool is never quietly skipped."""
    bad = tmp_path / "p2f.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(t_p2f, "P2F_SRC", bad)
    monkeypatch.setattr(t_p2f, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the p2f tool failed"):
        t_p2f.ensure_built()
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        t_p2f.ensure_built()


def _read_csv(path):
    lines = path.read_text().splitlines()
    return lines[0].split(","), [ln.split(",") for ln in lines[1:]]


def test_evaluate_cli_matches_jax(tmp_path, capsys):
    """`cli.evaluate --device cpu` against the JAX CLI on one directory
    pair with the p2f side-files: the same header and rows, CD and HD
    within 2e-6, EMD within 1e-5 relative, JSD / P2F / uniformity equal.
    The preds have the GT's size, so no random pad is drawn."""
    verts, faces = icosphere(3)
    mesh = tmp_path / "s.off"
    save_off(str(mesh), verts, faces)
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    rng = np.random.RandomState(0)
    for name in ("a", "b"):
        pts = rng.normal(size=(384, 3)).astype(np.float32)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        np.savetxt(gt_dir / f"{name}.xyz", pts, fmt="%.6f")
        noisy = pts + rng.normal(scale=2e-2, size=pts.shape)
        np.savetxt(pred_dir / f"{name}.xyz", noisy, fmt="%.6f")
        t_p2f.run_p2f(str(mesh), str(pred_dir / f"{name}.xyz"),
                      uniform=True, seed=5, samples=100)

    row_t = t_evaluate.main(["--pred", str(pred_dir), "--gt", str(gt_dir),
                             "--save_path", str(tmp_path / "t"),
                             "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    row_j = j_evaluate.main(["--pred", str(pred_dir), "--gt", str(gt_dir),
                             "--save_path", str(tmp_path / "j")])
    printed_j = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("evaluated 2 files in ")
    assert [ln.split(":")[0] for ln in printed[1:4]] == [
        "  ms of each file, CD/HD/EMD on cpu", "  ms of each file, JSD",
        "  ms of each file, P2F and uniformity"]
    assert printed[4] == f"Evaluation: {tmp_path / 't'}"
    keys = [m.split("]")[0] for m in printed[5].split()]
    assert keys == [m.split("]")[0] for m in printed_j[1].split()]

    head_t, rows_t = _read_csv(tmp_path / "t" / "evaluation.csv")
    head_j, rows_j = _read_csv(tmp_path / "j" / "evaluation.csv")
    assert head_t == head_j and len(head_t) == 12
    assert len(rows_t) == len(rows_j) == 3
    for r_t, r_j in zip(rows_t, rows_j):
        assert r_t[0] == r_j[0]
        assert "-" not in r_t[1:]
        for col, a, b in zip(head_t[1:], r_t[1:], r_j[1:]):
            if col == "EMD":
                assert abs(float(a) - float(b)) <= EMD_RTOL * abs(float(b))
            elif col in ("CD", "hausdorff"):
                assert abs(float(a) - float(b)) <= CHAMFER_ATOL, col
            else:
                assert a == b, col
    assert set(row_t) == set(row_j)
    assert rows_t[-1][0] == "-"


def test_evaluate_pads_a_short_pred_at_random(tmp_path):
    """A pred cloud with fewer points than its GT is padded with its own
    points, as the reference's `load_xyz` pads it."""
    path = tmp_path / "p.xyz"
    pts = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    np.savetxt(path, pts, fmt="%.6f")
    got = t_evaluate.load_xyz_count(str(path), count=16)
    assert got.shape == (16, 3)
    np.testing.assert_array_equal(got[:10], t_evaluate.load(str(path)))
    rows = {tuple(r) for r in got[:10]}
    assert all(tuple(r) in rows for r in got[10:])
