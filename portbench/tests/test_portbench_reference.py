"""The plain references: they import nothing of the package under test,
their solutions satisfy the KKT conditions to rounding, and their gradients
agree with central differences of their own solves."""

import ast
import subprocess
import sys
from pathlib import Path

import torch

from portbench.reference import nnqp
from portbench.reference import qcqp as ref

ROOT = Path(__file__).resolve().parents[2]


def _problems(B, nc, seed):
    n = 2 * nc
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(B, n, n, generator=g, dtype=torch.float64) / n ** 0.5
    P = s @ s.transpose(1, 2) + 0.1 * torch.eye(n, dtype=torch.float64)
    q = torch.randn(B, n, generator=g, dtype=torch.float64) * 0.5
    l_n = torch.rand(B, nc, generator=g, dtype=torch.float64) * 0.5 + 0.05
    mu = torch.rand(B, nc, generator=g, dtype=torch.float64) * 0.5 + 0.05
    return P, q, l_n, mu


def test_reference_imports_nothing_of_the_package():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert (name.split(".")[0] in ("torch", "__future__", "")
                        or name.startswith("portbench.reference.")), (path.name, name)
    code = ("import sys; import portbench.reference.qcqp, portbench.reference.nnqp; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('diffqcqp_tpu_torch', 'diffqcqp_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_reference_solves_to_rounding():
    sol = ref.solve(*_problems(64, 6, 0))
    assert float(ref.residuals(sol).max()) < 1e-12
    assert 0.5 < float(sol.active.double().mean()) < 1.0


def test_reference_gradients_match_central_differences():
    P, q, l_n, mu = _problems(8, 3, 1)
    sol = ref.solve(P, q, l_n, mu)
    grads = ref.gradients(sol, 2.0 * sol.l, l_n, mu)

    def loss(*xs):
        return (ref.solve(*xs).l ** 2).sum(-1)

    h = 1e-6
    xs = [P, q, l_n, mu]
    for k, idx in ((0, (0, 1, 2)), (1, (1, 3)), (2, (2, 1)), (3, (3, 0))):
        up = [x.clone() for x in xs]
        dn = [x.clone() for x in xs]
        up[k][idx] += h
        dn[k][idx] -= h
        if k == 0:      # P is symmetric: move both of its mirrored entries
            up[k][idx[0], idx[2], idx[1]] += h
            dn[k][idx[0], idx[2], idx[1]] -= h
        fd = float((loss(*up) - loss(*dn))[idx[0]]) / (2 * h)
        g = float(grads[k][idx])
        if k == 0:
            g = 2 * g
        assert abs(fd - g) <= 1e-6 * max(1.0, abs(fd)), (k, fd, g)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11], dtype=torch.float32)
    assert ref.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10]


def test_nnqp_reference_solves_to_rounding():
    P, q, _, _ = _problems(64, 12, 2)
    sol = nnqp.solve(P, q)
    assert float(nnqp.residuals(sol).max()) < 1e-12
    assert bool((sol.l[sol.active] == 0).all())
    assert 0.2 < float(sol.active.double().mean()) < 0.8


def test_nnqp_reference_gradients_match_central_differences():
    P, q, _, _ = _problems(8, 3, 3)
    sol = nnqp.solve(P, q)
    dP, dq = nnqp.gradients(sol, 2.0 * sol.l)

    def loss(P, q):
        return (nnqp.solve(P, q).l ** 2).sum(-1)

    h = 1e-6
    for k, idx in ((0, (0, 1, 2)), (0, (5, 4, 4)), (1, (1, 3)), (1, (6, 0))):
        up, dn = [P.clone(), q.clone()], [P.clone(), q.clone()]
        up[k][idx] += h
        dn[k][idx] -= h
        if k == 0 and idx[1] != idx[2]:     # P is symmetric: move both mirrored entries
            up[k][idx[0], idx[2], idx[1]] += h
            dn[k][idx[0], idx[2], idx[1]] -= h
        fd = float((loss(*up) - loss(*dn))[idx[0]]) / (2 * h)
        g = float((dP, dq)[k][idx])
        if k == 0 and idx[1] != idx[2]:
            g = 2 * g
        assert abs(fd - g) <= 1e-6 * max(1.0, abs(fd)), (k, idx, fd, g)
