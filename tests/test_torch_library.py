"""The ``torch.ops.puflow.*`` ops on CPU tensors: `torch.library.opcheck`
holds each op's schema, its fake implementation against the real one (on
the CPU, the kernel's plain version) and its trace with every dimension
dynamic (`test_aot_dispatch_dynamic`), at small shapes; the same checks on
CUDA tensors, where the real implementation launches the kernel, are in
tests/test_torch_cuda.py. Also each wrapper's CPU result through its op
against the plain version called directly.
"""

import pytest
import torch

from puflow_torch.ops import _build
from puflow_torch.ops import cnf as t_cnf
from puflow_torch.ops import encoder as t_encoder
from puflow_torch.ops import flow as t_flow
from puflow_torch.ops import fps as t_fps
from puflow_torch.ops import interp as t_interp
from puflow_torch.ops import knn as t_knn
from torch_op_cases import CASES, DIRECT, K, R, op_cases, op_model
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    return op_model("cpu")


@pytest.mark.parametrize("name", CASES)
def test_opcheck(model, name):
    op, args = op_cases(model)[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_serving_kernel_is_an_op():
    """The eleven C entries of the serving paths are reached through ten
    ops (one for FPS's one-block and cluster plans)."""
    names = {n for n in dir(torch.ops.puflow)
             if isinstance(getattr(torch.ops.puflow, n),
                           torch._ops.OpOverloadPacket)}
    assert names == set(DIRECT)


def test_wrappers_equal_plain_versions(model):
    """On CPU tensors each wrapper's result, through its op, is its plain
    version's, bit for bit."""
    f, xyz, idx, cs = model["folded"], model["xyz"], model["idx"], model["cs"]
    idx8 = idx[..., :8]
    assert torch.equal(t_knn.knn_self(xyz, K), idx)
    assert torch.equal(t_knn.knn_self_stream(xyz, K), idx)
    for a, b in zip(t_encoder.encoder_conditions(f, xyz, idx), cs):
        assert torch.equal(a, b)
    assert torch.equal(t_interp.interp_head(f["interp"], xyz, idx8, R),
                       model["ws"])
    blocks = f["flow_blocks"]
    assert torch.equal(t_flow.flow_f(blocks, xyz, cs),
                       t_flow.flow_f_plain(blocks, xyz, cs))
    assert torch.equal(
        t_flow.flow_g_blend(blocks, model["z"], model["ws"], idx8, cs),
        t_flow.flow_g_blend_plain(blocks, model["z"], model["ws"], idx8, cs))
    assert torch.equal(t_fps.farthest_point_sample(xyz, 9),
                       t_fps.farthest_point_sample_plain(xyz, 9))
    layers, c = model["layers"], model["c"]
    got, stats = t_cnf.cnf_solve_t(layers, c, xyz, 0.0, 0.5,
                                   return_stats=True)
    ref, ref_stats = t_cnf.cnf_solve_plain(layers, c, xyz, 0.0, 0.5,
                                           return_stats=True)
    assert torch.equal(got, ref) and stats == ref_stats


@pytest.mark.parametrize("tree", [
    {"a": [1, {"b": 2, "c": [3, 4]}], "d": 5},
    [[{"x": 0}], [], {"y": [1, 2]}],
    {"": 0, "k w": {"{": 1}},
])
def test_flatten_round_trip(tree):
    leaves, spelling = _build.flatten(tree)
    assert _build.unflatten(leaves, spelling) == tree
    again, same = _build.flatten(_build.unflatten(leaves, spelling))
    assert again == leaves and same == spelling
