"""puflow_torch's auction EMD against puflow_tpu's, on the CPU.

On one shared value matrix the auctions must agree exactly (the JAX
package pins `auction_from_value` to a transliteration of the reference
CUDA kernel, copied below). End to end the two frameworks build the
matrix in different orders, and the auction is chaotic on near-ties, so
the JAX package's own bounds apply: agreement > 0.95 and the matched cost
within 1e-2 (`tests/test_emd_oracle.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.ops import emd as t_emd
from puflow_tpu.ops.emd import auction_from_value as j_auction_from_value
from puflow_tpu.ops.emd import emd_auction as j_emd_auction
from torch_threads import one_torch_thread  # noqa: F401


def cuda_auction_oracle(base_value: np.ndarray, eps: float, iters: int):
    """numpy transliteration of the reference CUDA auction loop: a copy of
    `tests/test_emd_oracle.py:cuda_auction_oracle` (lowest bidder index
    among the +-1e-6 qualifiers)."""
    n, m = base_value.shape
    eps = np.float32(eps)
    assignment = np.full(n, -1, dtype=np.int64)
    assignment_inv = np.full(m, -1, dtype=np.int64)
    price = np.zeros(m, dtype=np.float32)

    for it in range(iters):
        last = it == iters - 1
        unass = np.nonzero(assignment == -1)[0]
        if unass.size == 0:
            break
        v = (base_value[unass] - price[None, :]).astype(np.float32)
        bid = np.argmax(v, axis=1)
        rows = np.arange(unass.size)
        best = v[rows, bid]
        v2 = v.copy()
        v2[rows, bid] = -np.inf
        second = v2.max(axis=1)
        bid_inc = (best - second + eps).astype(np.float32)

        max_inc = np.full(m, -1e9, dtype=np.float32)
        np.maximum.at(max_inc, bid, bid_inc)
        qual = np.abs(bid_inc - max_inc[bid]) <= 1e-6
        max_idx = np.full(m, n, dtype=np.int64)
        for r in range(unass.size):
            if qual[r] and unass[r] < max_idx[bid[r]]:
                max_idx[bid[r]] = unass[r]

        for r in range(unass.size):
            j, b = unass[r], bid[r]
            if last or max_idx[b] == j:
                old = assignment_inv[b]
                if not last and old != -1:
                    assignment[old] = -1
                assignment_inv[b] = j
                assignment[j] = b
                price[b] = np.float32(price[b] + bid_inc[r])
    return assignment


def _clouds(seed, b, n):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n, 3).astype(np.float32),
            rng.rand(b, n, 3).astype(np.float32))


@pytest.mark.parametrize("n,iters", [(256, 50), (1024, 50), (512, 7)])
def test_auction_on_shared_value_matrix_is_exact(n, iters):
    """One numpy value matrix into the port, JAX and the oracle: the same
    assignment, element for element."""
    x1, x2 = _clouds(n + iters, 1, n)
    base = t_emd.base_value(torch.from_numpy(x1),
                            torch.from_numpy(x2))[0].numpy()
    ours = t_emd.auction_from_value(torch.from_numpy(base), 0.005,
                                    iters).numpy()
    theirs = np.asarray(jax.jit(
        lambda v: j_auction_from_value(v, 0.005, iters))(jnp.asarray(base)))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, cuda_auction_oracle(base, 0.005,
                                                            iters))


@pytest.mark.parametrize("n", [256, 1024])
def test_emd_end_to_end_matches_jax(n):
    x1, x2 = _clouds(n, 2, n)
    before = t_emd.emd_auction.launches
    dist, assign = t_emd.emd_auction(torch.from_numpy(x1),
                                     torch.from_numpy(x2), 0.005, 50)
    assert t_emd.emd_auction.launches == before   # CPU: the plain version
    j_dist, j_assign = jax.jit(lambda a, b: j_emd_auction(a, b, 0.005, 50))(
        jnp.asarray(x1), jnp.asarray(x2))
    ours, theirs = assign.numpy(), np.asarray(j_assign)
    assert (ours == theirs).mean() > 0.95
    for b in range(2):
        cost = ((x1[b] - x2[b][ours[b]]) ** 2).sum()
        cost_j = ((x1[b] - x2[b][theirs[b]]) ** 2).sum()
        assert abs(cost - cost_j) / cost_j < 1e-2
        # dist is the squared distance of the port's own assignment
        np.testing.assert_allclose(dist.numpy()[b],
                                   ((x1[b] - x2[b][ours[b]]) ** 2).sum(-1),
                                   rtol=1e-5)
    np.testing.assert_allclose(np.asarray(j_dist)[ours == theirs],
                               dist.numpy()[ours == theirs], rtol=1e-5)


def test_emd_matches_pallas_kernel_interpret():
    """The TPU kernel in interpret mode, on the inputs of the JAX
    package's own kernel test (`tests/test_ops.py`)."""
    from puflow_tpu.ops.pallas.emd_pallas import emd_auction_pallas

    x1 = np.array(jax.random.uniform(jax.random.PRNGKey(7), (2, 64, 3)))
    x2 = np.array(jax.random.uniform(jax.random.PRNGKey(8), (2, 64, 3)))
    d_p, a_p = emd_auction_pallas(jnp.asarray(x1), jnp.asarray(x2), 0.005,
                                  50, interpret=True)
    dist, assign = t_emd.emd_auction(torch.from_numpy(x1),
                                     torch.from_numpy(x2), 0.005, 50)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(a_p))
    np.testing.assert_allclose(dist.numpy(), np.asarray(d_p), atol=1e-5)


def test_emd_gradient_matches_reference_rule():
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.rand(1, 16, 3).astype(np.float32),
                     requires_grad=True)
    y = torch.tensor(rng.rand(1, 16, 3).astype(np.float32),
                     requires_grad=True)
    loss = t_emd.emd_loss(x, y, eps=0.01, iters=100)
    gx, gy = torch.autograd.grad(loss, (x, y), allow_unused=True)
    _, assign = t_emd.emd_auction(x.detach(), y.detach(), 0.01, 100)
    want = 2.0 * (x.detach()[0] - y.detach()[0][assign[0]])
    np.testing.assert_allclose(gx[0].numpy(), want.numpy(), atol=1e-5)
    assert gy is None                       # no gradient for the target


def test_emd_plain_matches_jax_gradient():
    """jax.grad of the JAX EMD loss against the port's autograd, on a
    pair where both take the same assignment."""
    from puflow_tpu.ops.emd import emd_loss as j_emd_loss

    x1, x2 = _clouds(11, 2, 96)
    j_grad = jax.grad(lambda a: j_emd_loss(a, jnp.asarray(x2), None, 0.005,
                                           20))(jnp.asarray(x1))
    x = torch.tensor(x1, requires_grad=True)
    (grad,) = torch.autograd.grad(
        t_emd.emd_loss(x, torch.from_numpy(x2), None, 0.005, 20), x)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)


def test_emd_non_finite_input_gives_non_finite_dist():
    x1, x2 = _clouds(4, 2, 32)
    x1[0, 3] = np.nan
    dist, assign = t_emd.emd_auction(torch.from_numpy(x1),
                                     torch.from_numpy(x2), 0.005, 10)
    assert not bool(torch.isfinite(dist[0, 3]))
    assert bool(torch.isfinite(dist[1]).all())
    # the NaN row never bids and keeps -1, as in the kernel; the rest match
    assert int(assign[0, 3]) == -1
    others = torch.cat([assign[0, :3], assign[0, 4:], assign[1]])
    assert int(others.min()) >= 0 and int(assign.max()) < 32


def test_emd_rejects_bad_shapes():
    x = torch.zeros((2, 8, 3))
    with pytest.raises(ValueError, match="m >= 2"):
        t_emd.emd_auction(x, torch.zeros((2, 1, 3)))
    with pytest.raises(ValueError, match="iters"):
        t_emd.emd_auction(x, x, 0.005, 0)
    with pytest.raises(ValueError, match=r"\[B, n, 3\]"):
        t_emd.emd_auction(x, torch.zeros((3, 8, 3)))
