"""The port's plain dopri5 solver against puflow_tpu's early-exit solver.

Both run the same controller in float32, so on these small systems the
accept / reject sequence is the same (equal step counts, asserted) and the
end states of a converged solve differ by rounding only: 2e-6 of the
state's scale (measured at most 4.4e-7 of it; the backward solves of these
decaying systems grow to 22 and 360).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models.ode import odeint_dopri5 as t_odeint
from puflow_tpu.models.ode import odeint_dopri5 as j_odeint
from torch_threads import one_torch_thread  # noqa: F401

A = np.array([[-0.5, -3.0, 0.0], [3.0, -0.5, 0.0], [0.0, 0.0, -4.0]],
             np.float32)


def _fields(name):
    """(jax field, torch field, y0) of a small system."""
    if name == "scalar":
        # dy/dt = -2 y + sin(5 t)
        return (lambda t, y: -2.0 * y + jnp.sin(5.0 * t),
                lambda t, y: -2.0 * y + torch.sin(5.0 * t),
                np.array([1.5], np.float32))
    if name == "linear":
        return (lambda t, y: y @ jnp.asarray(A).T,
                lambda t, y: y @ torch.from_numpy(A).T,
                np.array([[1.0, 0.0, 2.0], [0.3, -0.7, 1.0]], np.float32))
    # stiff enough near t = 0 that the first steps are rejected
    return (lambda t, y: -60.0 * (y - jnp.cos(t)),
            lambda t, y: -60.0 * (y - torch.cos(t)),
            np.array([0.0, 2.0], np.float32))


@pytest.mark.parametrize("name,t0,t1", [
    ("scalar", 0.0, 1.3), ("scalar", 1.3, 0.0), ("linear", 0.0, 1.3),
    ("linear", 1.3, 0.0), ("rejecting", 0.0, 1.3), ("rejecting", 0.5, 1.3)])
def test_odeint_matches_jax(name, t0, t1):
    jf, tf, y0 = _fields(name)
    ref, rst = j_odeint(jf, jnp.asarray(y0), t0, t1, 1e-5, 1e-5,
                        differentiable=False, return_stats=True)
    got, gst = t_odeint(tf, torch.from_numpy(y0), t0, t1, 1e-5, 1e-5,
                        differentiable=False, return_stats=True)
    assert gst["steps"] == int(rst["steps"])
    assert gst["nfe"] == int(rst["nfe"]) == 1 + 6 * gst["steps"]
    assert gst["accepted"] <= gst["steps"]
    if name == "rejecting" and t1 > t0:
        assert gst["accepted"] < gst["steps"]
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    print(f"{name} {t0}->{t1}: steps {gst}, max_abs_err {err:.3e} at scale "
          f"{scale:.3g}")
    assert err <= 2e-6 * scale


def test_odeint_tuple_state_and_tensor_bounds():
    """A tuple state shares one error norm; t1 may be a 0-dim tensor."""
    y0 = np.array([[1.0, 0.0, 2.0]], np.float32)
    l0 = np.zeros((1, 1), np.float32)

    def jf(t, s):
        y, _ = s
        return y @ jnp.asarray(A).T, jnp.sum(y, -1, keepdims=True) * t

    def tf(t, s):
        y, _ = s
        return y @ torch.from_numpy(A).T, torch.sum(y, -1, keepdim=True) * t

    (ry, rl), rst = j_odeint(jf, (jnp.asarray(y0), jnp.asarray(l0)), 0.0,
                             jnp.asarray(0.8), 1e-5, 1e-5,
                             differentiable=False, return_stats=True)
    (gy, gl), gst = t_odeint(tf, (torch.from_numpy(y0), torch.from_numpy(l0)),
                             0.0, torch.tensor(0.8), 1e-5, 1e-5,
                             differentiable=False, return_stats=True)
    assert gst["steps"] == int(rst["steps"])
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=2e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=2e-6)


def test_odeint_zero_span_and_step_budget():
    _, tf, y0 = _fields("linear")
    y = torch.from_numpy(y0)
    out, st = t_odeint(tf, y, 0.4, 0.4, differentiable=False,
                       return_stats=True)
    assert st["steps"] == 0 and torch.equal(out, y)
    # An unconverged solve keeps the last state it reached. Its time is not
    # pinned to rounding: the error estimate is a difference of nearly
    # equal sums (about 1e-5 relative in float32), the next step size
    # inherits that, and here the first step is rejected. So the states
    # agree to 5e-4 (measured 4.1e-5), the step counts exactly.
    jf, _, _ = _fields("linear")
    ref, rst = j_odeint(jf, jnp.asarray(y0), 0.0, 5.0, 1e-5, 1e-5, 3,
                        differentiable=False, return_stats=True)
    got, gst = t_odeint(tf, y, 0.0, 5.0, 1e-5, 1e-5, 3, differentiable=False,
                        return_stats=True)
    assert gst["steps"] == int(rst["steps"]) == 3
    assert gst["accepted"] == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)


def test_odeint_differentiable_is_not_ported():
    """The default driver, the masked fixed-trip loop (its name is from
    before the loop was ported): it ends where the early-exit loop ends,
    and autograd differentiates it. dy/dt = -2 y + sin(5 t) has
    dy(1)/dy(0) = exp(-2)."""
    _, tf, y0 = _fields("scalar")
    y = torch.from_numpy(y0).requires_grad_()
    got = t_odeint(tf, y, 0.0, 1.0)
    ref = t_odeint(tf, y.detach(), 0.0, 1.0, differentiable=False)
    assert float((got - ref).abs().max()) <= 2e-6
    (grad,) = torch.autograd.grad(got.sum(), y)
    assert abs(float(grad) - np.exp(-2.0)) < 1e-4
