"""Differentiable system identification through the contact solvers (port of
models/system_id.py): QP / QCQP contact-force solves inside an Adam loop
that recovers physical parameters (inertia-like P, bias q, normal forces
l_n, friction coefficients mu) from observed contact forces.

``SystemID`` is an ``nn.Module`` whose parameters are ``nn.Parameter``s and
whose optimiser is ``torch.optim.Adam(learning_rate)`` (optax.adam's
defaults b1 = 0.9, b2 = 0.999, eps = 1e-8 are torch's):

    model = SystemID(kind="qp", config=cfg, device="cuda")
    model.init_qp(torch.Generator().manual_seed(0), batch=10, n=8, diag=True)
    for _ in range(steps):
        loss = model.train_step(target)

Every solve runs on the model's ``device`` (the card by default, raising
without CUDA; ``device="cpu"`` for the plain path). On the card
``train_step`` is staged, as the JAX package's ``jax.jit(self._train_step)``:
forward, backward and a capturable Adam step are captured as one CUDA graph
(``utils/staging.py``) after a few eager steps and replayed from then on.
A model is staged where its route can be captured (``capturable_route``:
K1 or the engine forward, any adjoint route backward; a diagonal P, n past
the kernels' bounds, float64, ``accel`` and ``backend='xla'`` included, the
engine's spectral mode through the Jacobi kernel E1, and the lockstep mode
(``axis_name``), whose steps run inside ``parallel.lockstep(mesh)`` on a
one-card mesh with no group or a one-rank NCCL one; across ranks or over
gloo the capture raises the guard's error). Every model on the CPU trains
eagerly.
``params_from_numpy`` carries the JAX package's parameters
(``QPSystemIDParams`` / ``QCQPSystemIDParams`` of arrays) into the port's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from ..api import capturable, solve_qcqp, solve_qp
from ..config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from ..utils.shapes import canon_problem, fields_from_numpy
from ..utils.staging import Staged, staged

__all__ = [
    "QPSystemIDParams",
    "QCQPSystemIDParams",
    "qp_params_to_problem",
    "qcqp_params_to_problem",
    "params_from_numpy",
    "capturable_route",
    "SystemID",
]


class QPSystemIDParams(NamedTuple):
    """Learnable QP parameters. P is stored through a square-root factor S
    (P = S S^T + reg I) so it stays PSD while it is optimised; the diagonal
    variant stores log-diagonals."""

    S: torch.Tensor          # (B, N, N), or (B, N) log-diagonal
    q: torch.Tensor          # (B, N)


class QCQPSystemIDParams(NamedTuple):
    S: torch.Tensor          # (B, N, N)
    q: torch.Tensor          # (B, N)
    log_l_n: torch.Tensor    # (B, nc): positivity through exp
    logit_mu: torch.Tensor   # (B, nc): (0, 1) through the sigmoid


Params = Union[QPSystemIDParams, QCQPSystemIDParams]


def _gram(S: torch.Tensor, reg: float) -> torch.Tensor:
    return S @ S.mT + reg * torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)


def qp_params_to_problem(p: QPSystemIDParams, reg: float = 1e-3):
    """(P, q): P = exp(S) for a log-diagonal S, else S S^T + reg I."""
    P = torch.exp(p.S) if p.S.ndim == 2 else _gram(p.S, reg)
    return P, p.q


def qcqp_params_to_problem(p: QCQPSystemIDParams, reg: float = 1e-3):
    """(P, q, l_n, mu) = (S S^T + reg I, q, exp(log_l_n), sigmoid(logit_mu))."""
    return _gram(p.S, reg), p.q, torch.exp(p.log_l_n), torch.sigmoid(p.logit_mu)


def params_from_numpy(p, device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's ``QPSystemIDParams`` / ``QCQPSystemIDParams`` (or
    any named tuple of arrays with the same fields) as the port's, each
    field a tensor on ``device`` (in ``dtype``, default: the arrays')."""
    return fields_from_numpy(QCQPSystemIDParams if hasattr(p, "log_l_n") else QPSystemIDParams,
                             p, device, dtype)


def capturable_route(kind: str, params: Params, config: SolverConfig) -> bool:
    """Whether a training step of ``params`` takes a route that a CUDA graph
    can hold, forward and backward (``api.capturable``: the dispatch and
    the capture guard's rule). Decided from shapes, dtype and config, as
    the dispatch is, on any device."""
    with torch.no_grad():
        P, q = (qp_params_to_problem if kind == "qp" else qcqp_params_to_problem)(params)[:2]
        c = canon_problem(P, q)
    return capturable(c.P, c.q, config)


class SystemID(nn.Module):
    """Adam system identification over the differentiable solvers: the
    parameters (``params``) are the module's ``nn.Parameter``s, set by
    ``init_qp`` / ``init_qcqp`` or ``set_params``, each of which also makes
    a fresh ``torch.optim.Adam`` over them (``opt``) and drops any captured
    step. Where the step is staged (on the card, on a capturable route) the
    Adam is ``capturable=True``, its state on the device, so that the graph
    can update it in place."""

    def __init__(
        self,
        kind: str = "qp",
        config: Optional[SolverConfig] = None,
        learning_rate: float = 1e-2,
        device="cuda",
    ):
        super().__init__()
        if kind not in ("qp", "qcqp"):
            raise ValueError(f"kind must be 'qp' or 'qcqp', got {kind!r}")
        self.kind = kind
        base = QP_DEFAULTS if kind == "qp" else QCQP_DEFAULTS
        self.config = config if config is not None else base.replace(eps=1e-7)
        self.learning_rate = learning_rate
        self.device = device
        self._fields = (QPSystemIDParams if kind == "qp" else QCQPSystemIDParams)._fields
        self.opt: Optional[torch.optim.Adam] = None
        self._staged_step: Optional[Staged] = None

    def set_params(self, params: Params) -> Params:
        """Take ``params`` (the kind's named tuple of tensors) as the model's
        parameters, on its device, and start a new Adam over them."""
        if tuple(params._fields) != self._fields:
            raise ValueError(f"{self.kind} parameters have fields {self._fields}, "
                             f"got {params._fields}")
        for name, x in zip(self._fields, params):
            self.register_parameter(name, nn.Parameter(torch.as_tensor(x, device=self.device)))
        stage = (torch.device(self.device).type == "cuda"
                 and capturable_route(self.kind, self.params, self.config))
        self.opt = torch.optim.Adam(self.parameters(), lr=self.learning_rate, capturable=stage)
        self._staged_step = staged(self._train_step) if stage else None
        return self.params

    @property
    def params(self) -> Params:
        cls = QPSystemIDParams if self.kind == "qp" else QCQPSystemIDParams
        return cls(*(getattr(self, name) for name in self._fields))

    def init_qp(self, generator: torch.Generator, batch: int, n: int, diag: bool = False,
                dtype: torch.dtype = torch.float32) -> QPSystemIDParams:
        """Random QP parameters from ``generator`` (drawn on the CPU, so the
        same seed gives the same parameters on every device): S ~ N(0, 1) /
        sqrt(n) dense, or N(0, 0.09) log-diagonal; q ~ N(0, 0.09)."""
        def draw(*shape):
            return torch.randn(*shape, generator=generator, dtype=dtype)

        S = draw(batch, n) * 0.3 if diag else draw(batch, n, n) * (1.0 / math.sqrt(n))
        return self.set_params(QPSystemIDParams(S=S, q=draw(batch, n) * 0.3))

    def init_qcqp(self, generator: torch.Generator, batch: int, nc: int,
                  dtype: torch.dtype = torch.float32) -> QCQPSystemIDParams:
        """Random QCQP parameters from ``generator``: S ~ N(0, 1) / sqrt(n),
        q ~ N(0, 0.09), log_l_n and logit_mu ~ N(0, 0.01)."""
        n = 2 * nc

        def draw(*shape):
            return torch.randn(*shape, generator=generator, dtype=dtype)

        return self.set_params(QCQPSystemIDParams(
            S=draw(batch, n, n) * (1.0 / math.sqrt(n)), q=draw(batch, n) * 0.3,
            log_l_n=draw(batch, nc) * 0.1, logit_mu=draw(batch, nc) * 0.1,
        ))

    def forward(self) -> torch.Tensor:
        """The solution l of the problems the parameters define."""
        if self.kind == "qp":
            P, q = qp_params_to_problem(self.params)
            return solve_qp(P, q, config=self.config, device=self.device)
        P, q, l_n, mu = qcqp_params_to_problem(self.params)
        return solve_qcqp(P, q, l_n, mu, config=self.config, device=self.device)

    def loss(self, target: torch.Tensor) -> torch.Tensor:
        """Mean squared error of the solution against ``target``."""
        return torch.mean((self() - target) ** 2)

    def _train_step(self, target: torch.Tensor) -> torch.Tensor:
        """One Adam step, eagerly; returns the loss before it (detached)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(target)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_step(self, target: torch.Tensor) -> torch.Tensor:
        """One Adam step; returns the loss before it (detached; where the
        step is staged, a clone of the graph's loss, see the module's
        docstring)."""
        if self.opt is None:
            raise RuntimeError("no parameters: call init_qp, init_qcqp or set_params first")
        if self._staged_step is None:
            return self._train_step(target)
        return self._staged_step(target)
