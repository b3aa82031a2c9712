"""Small cases of the ``torch.ops.puflow.*`` ops on any device, shared by
tests/test_torch_library.py (CPU) and tests/test_torch_cuda.py (card), and
each op's kernel launch without the op (`DIRECT`), which
`chip_smoke.py` times beside the op. Imports no jax.
"""

import numpy as np
import torch

from puflow_torch import checkpoint
from puflow_torch.models import continuous, discrete
from puflow_torch.models.fold_bn import fold_bn_inference
from puflow_torch.ops import _build, cnf, encoder, flow, fps, interp, knn

B, N, K, R = 2, 24, 16, 4

CASES = ["knn_self", "knn_self_stream", "encoder", "interp_head_weights",
         "interp_head_logits", "interp_head_latents", "flow_f", "flow_g",
         "flow_g_blend", "cnf_solve", "cnf_solve_repeated", "fps",
         "fps_seeded"]


def op_model(device) -> dict:
    """Full-width folded discrete params and a CNF block, seeded and
    perturbed, on ``device``, with inputs made with numpy; the
    conditions, weights and graph come from the plain versions."""
    gen = torch.Generator().manual_seed(0)
    params, state = checkpoint.to_numpy_tree(
        discrete.DiscreteModel(*discrete.init(gen, device="cpu")))
    discrete.perturb_init(params, state, 3)
    tp, ts = checkpoint.from_numpy_tree(params, state, device).trees()
    folded = fold_bn_inference(tp, ts)
    cnf_params, _ = continuous.init(torch.Generator().manual_seed(1), "cpu")
    block = [{k: {kk: t.to(device) for kk, t in v.items()}
              for k, v in layer.items()}
             for layer in cnf_params["flow_blocks"][0]["layers"]]
    rng = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).to(device)

    xyz = randn(B, N, 3, scale=0.3)
    idx = knn.knn_self_plain(xyz, K)
    cdim = block[0]["hyper_gate"]["w"].shape[0] - 1
    return dict(
        folded=folded, layers=block, xyz=xyz, idx=idx,
        cs=encoder.encoder_conditions_plain(folded, xyz, idx),
        ws=interp.interp_head_plain(folded["interp"], xyz, idx[..., :8], R),
        z=randn(B, N, 3), fz=randn(B, N, 3, R), c=randn(B, N, cdim),
        clouds=randn(B, 40, 3), rows=randn(2 * B, 30, 3),
        seeds=randn(B, 5, 3))


def op_cases(m: dict) -> dict:
    """case name -> (op, args) at small shapes; the graph views are passed
    as the model passes them (``idx[..., :8]``)."""
    f = m["folded"]
    enc = _build.flatten({"feat_convs": f["feat_convs"],
                          "merge_convs": f["merge_convs"]})
    head = _build.flatten(f["interp"])
    blocks = _build.flatten(list(f["flow_blocks"]))
    layers = _build.flatten(m["layers"])
    xyz, idx8, c = m["xyz"], m["idx"][..., :8], m["c"]
    t0 = torch.tensor(0.0, device=xyz.device)
    t1 = torch.tensor(0.5, device=xyz.device)
    ops = torch.ops.puflow
    return {
        "knn_self": (ops.knn_self, (xyz, 5)),
        "knn_self_stream": (ops.knn_self_stream, (xyz, 5)),
        "encoder": (ops.encoder, (xyz, m["idx"], *enc)),
        "interp_head_weights": (ops.interp_head,
                                (xyz, idx8, *head, R, "weights", None)),
        "interp_head_logits": (ops.interp_head,
                               (xyz, idx8, *head, R, "logits", None)),
        "interp_head_latents": (ops.interp_head,
                                (xyz, idx8, *head, R, "latents", m["z"])),
        "flow_f": (ops.flow_f, (xyz, m["cs"], *blocks)),
        "flow_g": (ops.flow_g, (m["fz"], m["cs"], *blocks)),
        "flow_g_blend": (ops.flow_g_blend,
                         (m["z"], m["ws"], idx8, m["cs"], *blocks)),
        "cnf_solve": (ops.cnf_solve,
                      (c, xyz, t0, t1, *layers, 1e-5, 1e-5, 128)),
        "cnf_solve_repeated": (ops.cnf_solve,
                               (c[:, :N // R], xyz, t1, t0, *layers, 1e-5,
                                1e-5, 128)),
        "fps": (ops.fps, (m["clouds"], 12, -1, -1)),
        "fps_seeded": (ops.fps_seeded, (m["rows"], m["seeds"], 7, -1, -1)),
    }


def _cnf_direct(c, y, t0, t1, leaves, tree, rtol, atol, max_steps):
    return cnf._cnf_kernel(_build.unflatten(leaves, tree), c, y, t0, t1,
                           y.shape[1] // c.shape[1], rtol, atol, max_steps)


def _plan(cluster, threads):
    return fps._plan_of(cluster, threads)


# op name -> the kernel's launch through ctypes on the op's own arguments
# (CUDA tensors), without the op's dispatch or its launch count
DIRECT = {
    "knn_self": knn._launch_self,
    "knn_self_stream": knn._launch_stream,
    "encoder": encoder._launch,
    "interp_head": interp._launch,
    "flow_f": flow._launch_f,
    "flow_g": flow._launch_g,
    "flow_g_blend": flow._launch_g_blend,
    "cnf_solve": _cnf_direct,
    "fps": lambda xyz, n, cluster, threads: fps._launch(
        xyz, n, _plan(cluster, threads)),
    "fps_seeded": lambda xyz, seeds, n, cluster, threads: fps._launch_seeded(
        xyz, seeds, n, _plan(cluster, threads)),
}
