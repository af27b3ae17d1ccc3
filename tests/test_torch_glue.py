"""P's symmetrisation and the solvers' grad_P as one pass each
(``kernels/glue_cuda.py``: G1 ``symmetrize``, G2 ``grad_p_cuda``) on the CPU,
where each runs its plain version: the same bits as the PyTorch formulas
they replaced, ``0.5 * (P + P^T)`` in ``canon_problem`` (differentiated by
autograd) and ``-0.5 * (dl l^T + l dl^T)`` in ``api._grad_P``.

The parent's computation is had by putting those formulas back in place
(``monkeypatch``): ``shapes.symmetrize`` -> ``symmetrize_plain`` called
outside the Function, so autograd differentiates its ops, and
``api.grad_p_cuda`` -> ``grad_p_plain``. Every comparison is ``torch.equal``: forward values,
``torch.autograd.grad`` for a non-symmetric P and a non-symmetric
cotangent, the four classes' solves, and ``torch.func.grad``, ``vmap`` and
``jacrev`` through ``solve_qp``. The kernels themselves are held to their
plain versions on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch
from torch.func import grad, jacrev, jvp, vmap

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch import api
from diffqcqp_tpu_torch.kernels import glue_cuda
from diffqcqp_tpu_torch.utils import shapes
from diffqcqp_tpu_torch.utils.shapes import canon_problem

B, N = 3, 6
DTYPES = (torch.float32, torch.float64)
CLASSES = ("qp", "box_qp", "signed_box_qp", "qcqp")


@pytest.fixture
def parent(monkeypatch):
    """Puts the parent's formulas back: a function that, called, makes
    every later call in the test compute as the parent did."""
    def use():
        monkeypatch.setattr(shapes, "symmetrize", glue_cuda.symmetrize_plain)
        monkeypatch.setattr(api, "grad_p_cuda", glue_cuda.grad_p_plain)
    return use


def _rand(*shape, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype)


def _problem(dtype, seed=0):
    """A batch of SPD P made non-symmetric by a skew part, q, and the QCQP's
    and boxes' parameters."""
    s = _rand(B, N, N, seed=seed) / N ** 0.5
    P = s @ s.mT + 0.5 * torch.eye(N, dtype=torch.float64)
    P = P + 0.1 * (_rand(B, N, N, seed=seed + 1) - _rand(B, N, N, seed=seed + 1).mT)
    q = _rand(B, N, seed=seed + 2)
    return P.to(dtype), q.to(dtype)


def _class_args(cls, P, q):
    dt = q.dtype
    if cls == "qp":
        return (P, q)
    if cls == "box_qp":
        return (P, q, torch.full_like(q, -0.3), torch.full_like(q, 0.4))
    if cls == "signed_box_qp":
        v = torch.tensor([1.0, -1.0, 0.0, 1.0, -1.0, 1.0], dtype=dt).expand(B, N)
        return (P, q, torch.full_like(q, -0.3), torch.full_like(q, 0.4), v)
    nc = N // 2
    return (P, q, torch.full((B, nc), 0.7, dtype=dt), torch.full((B, nc), 0.5, dtype=dt))


LAYOUTS = {     # P's layout -> (P, q) from a (B, N, N) P and (B, N) q
    "batched": lambda P, q: (P, q),
    "broadcast": lambda P, q: (P[:1], q),
    "shared": lambda P, q: (P[0], q),
    "unbatched": lambda P, q: (P[0], q[0]),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_canon_symmetrisation_is_the_parents_forward_and_adjoint(parent, dtype, layout):
    """canon_problem's P and the gradient of <G, P_canon> for a
    non-symmetric P and G equal the parent's bit for bit, in every dense
    layout (a broadcast batch of 1 and a shared (N, N) P among them)."""
    P0, q0 = LAYOUTS[layout](*_problem(dtype))
    G = _rand(B, N, N, dtype=dtype, seed=7)

    def run():
        P = P0.clone().requires_grad_()
        c = canon_problem(P, q0)
        (dP,) = torch.autograd.grad((c.P * G[: c.P.shape[0]]).sum(), P)
        return c.P.detach(), dP

    new = run()
    parent()
    old = run()
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert torch.equal(new[0], new[0].mT)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_diagonal_p_is_left_as_it_is(monkeypatch, dtype):
    """A (B, N) diagonal P is not symmetrised: canon_problem returns it as
    given and never calls symmetrize."""
    def refuse(P):
        raise AssertionError("symmetrize called on a diagonal P")

    monkeypatch.setattr(shapes, "symmetrize", refuse)
    P, q = _rand(B, N, dtype=dtype).abs() + 0.5, _rand(B, N, dtype=dtype, seed=1)
    assert torch.equal(canon_problem(P, q).P, P)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_grad_p_is_the_parents_formula_and_exactly_symmetric(dtype):
    """grad_p_cuda on CPU tensors equals the parent's -0.5 * (dl l^T + l dl^T) bit for bit,
    and its output equals its transpose exactly."""
    dl, l = _rand(B, N, dtype=dtype), _rand(B, N, dtype=dtype, seed=1)
    g = glue_cuda.grad_p_cuda(dl, l)
    assert torch.equal(g, -0.5 * (dl[:, :, None] * l[:, None, :] + l[:, :, None] * dl[:, None, :]))
    assert torch.equal(g, g.mT)


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_solve_and_gradients_are_the_parents(parent, cls, dtype):
    """Each class's l and the gradients of sum(l^2) + <w, l> for every
    input, at a non-symmetric P, equal the parent's bit for bit (float32:
    K1's and K4's or K2's plain versions; float64: the eager engine and the
    generic adjoint)."""
    P, q = _problem(dtype)
    w = _rand(B, N, dtype=dtype, seed=5)
    solve = getattr(dqt, f"solve_{cls}")

    def run():
        xs = [x.clone().requires_grad_(x.dtype.is_floating_point and i != 4)
              for i, x in enumerate(_class_args(cls, P, q))]
        l = solve(*xs, eps=1e-9, max_iter=2000, device="cpu")
        gs = torch.autograd.grad((l * l).sum() + (w * l).sum(), [x for x in xs if x.requires_grad])
        return (l.detach(), *gs)

    new = run()
    parent()
    old = run()
    assert len(new) == len(old)
    assert all(torch.equal(a, b) for a, b in zip(new, old))


TRANSFORMS = {
    "grad": lambda f, P, q: grad(lambda P_: (f(P_, q) ** 2).sum())(P),
    "vmap_grad": lambda f, P, q: vmap(grad(lambda P_, q_: (f(P_, q_) ** 2).sum()))(P, q),
    "jacrev": lambda f, P, q: jacrev(f)(P, q),
}


@pytest.mark.parametrize("transform", list(TRANSFORMS))
def test_torch_func_through_solve_qp_is_the_parents(parent, transform):
    """torch.func.grad, vmap(grad) (unbatched problems) and jacrev through
    solve_qp on the kernel route's plain versions (float32) give the
    parent's values bit for bit."""
    P, q = _problem(torch.float32)
    f = lambda P_, q_: dqt.solve_qp(P_, q_, eps=1e-7, max_iter=400, device="cpu")  # noqa: E731
    new = TRANSFORMS[transform](f, P, q)
    parent()
    old = TRANSFORMS[transform](f, P, q)
    assert torch.equal(new, old)


def test_symmetrize_function_rules():
    """symmetrize's own rules: vmap over an outer dimension at any
    position, forward mode and a second derivative (its backward is the
    Function again) agree with the plain map."""
    X = _rand(2, B, N, N)
    plain = glue_cuda.symmetrize_plain
    assert torch.equal(vmap(glue_cuda.symmetrize)(X), plain(X))
    assert torch.equal(vmap(glue_cuda.symmetrize, in_dims=1)(X), plain(X.movedim(1, 0)))
    T = _rand(2, B, N, N, seed=3)
    _, tangent = jvp(glue_cuda.symmetrize, (X,), (T,))
    assert torch.equal(tangent, plain(T))
    Y = X.clone().requires_grad_()
    assert torch.autograd.gradcheck(glue_cuda.symmetrize, (Y,))
    assert torch.autograd.gradgradcheck(glue_cuda.symmetrize, (Y,))


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the routes run the plain versions and count no
    launch."""
    before = (glue_cuda.symmetrize_cuda.launches, glue_cuda.grad_p_cuda.launches)
    P, q = _problem(torch.float32)
    P.requires_grad_()
    (dqt.solve_qp(P, q, device="cpu") ** 2).sum().backward()
    assert (glue_cuda.symmetrize_cuda.launches, glue_cuda.grad_p_cuda.launches) == before
