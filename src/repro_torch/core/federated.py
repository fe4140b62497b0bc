"""Federated problems and the one-cell run (port of ``repro/core/federated.py``).

N workers hold heterogeneous local datasets ``X [N, n, d]``, ``Y [N, n]``.
The losses are the reference's least-squares and logistic losses; their
minibatch gradients are written in closed form (the same maths as
``jax.grad`` of the reference's ``local_loss``), batched over grid cells:
``w [..., d]`` gives ``[..., N, d]`` gradients.

The ``make_*_problem`` builders draw from a ``torch.Generator`` seeded with
``seed`` on the run's device, so their data differ from the reference's;
tests carry the reference's arrays across with ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core import artemis as art


@dataclasses.dataclass(frozen=True)
class Problem:
    """N-worker problem with stacked data X: [N, n, d], Y: [N, n]."""
    X: torch.Tensor
    Y: torch.Tensor
    kind: str                   # 'lsr' | 'logistic'
    reg: float = 0.0            # l2 regularization

    def __post_init__(self):
        if self.kind not in ("lsr", "logistic"):
            raise ValueError(f"unknown problem kind {self.kind!r}")

    @property
    def n_workers(self) -> int:
        return self.X.shape[0]

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    def _dloss(self, pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """d(per-sample loss)/d(pred)."""
        if self.kind == "lsr":
            return pred - y
        return -y * torch.sigmoid(-y * pred)

    def global_loss(self, w: torch.Tensor) -> torch.Tensor:
        """F(w) = mean over workers of the local mean loss; w [..., d]."""
        pred = torch.einsum("nbd,...d->...nb", self.X, w)
        if self.kind == "lsr":
            per = 0.5 * (pred - self.Y) ** 2
        else:
            per = torch.logaddexp(torch.zeros_like(pred), -self.Y * pred)
        local = per.mean(-1) + (0.5 * self.reg * (w * w).sum(-1))[..., None]
        return local.mean(-1)

    def worker_grad(self, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Minibatch gradients [..., N, d] at w [..., d]; idx [..., N, b]
        holds each worker's sample indices."""
        workers = torch.arange(self.n_workers, device=idx.device)[:, None]
        x, y = self.X[workers, idx], self.Y[workers, idx]
        pred = torch.einsum("...nbd,...d->...nb", x, w)
        ct = self._dloss(pred, y) / idx.shape[-1]
        return (torch.einsum("...nbd,...nb->...nd", x, ct)
                + self.reg * w[..., None, :])

    def full_grad(self, w: torch.Tensor) -> torch.Tensor:
        """Full local gradients [..., N, d] at w [..., d]."""
        pred = torch.einsum("nbd,...d->...nb", self.X, w)
        ct = self._dloss(pred, self.Y) / self.X.shape[1]
        return (torch.einsum("nbd,...nb->...nd", self.X, ct)
                + self.reg * w[..., None, :])

    def smoothness(self) -> float:
        """L: max_i top eigenvalue of X_i^T X_i / n (times 1/4 for
        logistic), plus reg."""
        cov = self.X.transpose(1, 2) @ self.X / self.X.shape[1]
        lam = torch.linalg.eigvalsh(cov)[:, -1]
        scale = 1.0 if self.kind == "lsr" else 0.25
        return float(lam.max()) * scale + self.reg

    def solve_opt(self, iters: int = 3000) -> torch.Tensor:
        """w* by least squares (LSR without reg) or full-batch GD."""
        if self.kind == "lsr" and self.reg == 0.0:
            X = self.X.reshape(-1, self.dim)
            Y = self.Y.reshape(-1, 1)
            return torch.linalg.lstsq(X, Y).solution[:, 0]
        step = 1.0 / self.smoothness()
        w = torch.zeros(self.dim, dtype=self.X.dtype, device=self.device)
        for _ in range(iters):
            w = w - step * self.full_grad(w).mean(0)
        return w


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_lsr_problem(seed: int, n_workers=20, n_per=200, d=20, noise=0.4,
                     iid=True, *, device=None) -> Tuple[Problem, torch.Tensor]:
    """LSR: y = <w*, x> + e, e ~ N(0, noise^2).  noise=0 => sigma_* = 0."""
    dev = default_device(device)
    gen = _generator(seed, dev)
    w_true = torch.randn(d, generator=gen, device=dev)
    X = torch.randn(n_workers, n_per, d, generator=gen, device=dev)
    if not iid:
        # per-worker anisotropic covariances -> heterogeneous distributions
        X = X * (0.5 + 2.0 * torch.rand(n_workers, 1, d, generator=gen,
                                        device=dev))
    E = noise * torch.randn(n_workers, n_per, generator=gen, device=dev)
    Y = torch.einsum("nbd,d->nb", X, w_true) + E
    return Problem(X=X, Y=Y, kind="lsr"), w_true


def make_logistic_problem(seed: int, n_workers=20, n_per=200, d=2, *,
                          device=None) -> Problem:
    """Non-i.i.d. logistic: even workers use w1 = (10, 10, ..), odd ones
    w2 = (10, -10, ..), with mirrored input covariances (cov1 + cov2 = 3)."""
    dev = default_device(device)
    gen = _generator(seed, dev)
    w1 = torch.full((d,), 10.0, device=dev)
    w2 = torch.full((d,), 10.0, device=dev)
    w2[1:] = -10.0
    v = torch.rand(d, generator=gen, device=dev)
    cov1, cov2 = 1.0 + 0.5 * v, 2.0 - 0.5 * v
    even = (torch.arange(n_workers, device=dev) % 2 == 0)[:, None]
    cov = torch.where(even, cov1, cov2)[:, None, :]
    wm = torch.where(even, w1, w2)                       # [N, d]
    X = torch.randn(n_workers, n_per, d, generator=gen, device=dev) * cov
    pz = torch.sigmoid(torch.einsum("nbd,nd->nb", X, wm))
    Y = 2.0 * torch.bernoulli(pz, generator=gen) - 1.0
    return Problem(X=X, Y=Y, kind="logistic", reg=1e-3)


def make_clustered_problem(seed: int, n_workers=20, n_per=400, d=40,
                           noise=0.2, *, device=None) -> Problem:
    """Each worker's inputs come from its own Gaussian cluster (non-i.i.d.,
    unbalanced scales): the stand-in for the paper's clustered datasets."""
    dev = default_device(device)
    gen = _generator(seed, dev)
    centers = 3.0 * torch.randn(n_workers, d, generator=gen, device=dev)
    X = centers[:, None, :] + torch.randn(n_workers, n_per, d, generator=gen,
                                          device=dev)
    w_true = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    Y = (torch.einsum("nbd,d->nb", X, w_true)
         + noise * torch.randn(n_workers, n_per, generator=gen, device=dev))
    return Problem(X=X, Y=Y, kind="lsr", reg=1e-3)


@dataclasses.dataclass
class RunResult:
    losses: np.ndarray          # [E] F(w) at each eval point
    bits: np.ndarray            # [E] cumulative communicated bits
    w_final: np.ndarray
    w_avg: np.ndarray           # Polyak-Ruppert average (all iterates)
    w_tail_avg: np.ndarray      # average over the last half
    dist_to_opt: Optional[np.ndarray] = None


def run(problem: Problem, cfg: art.ArtemisConfig, gamma: float, iters: int,
        seed: int, batch: int = 1, w0: Optional[torch.Tensor] = None,
        full_batch: bool = False, w_star: Optional[torch.Tensor] = None,
        gamma_decay: bool = False, eval_every: int = 1,
        backend: Optional[str] = None) -> RunResult:
    """Run one variant at one step size and seed: a one-cell ``run_sweep``
    on the problem's device."""
    from repro_torch.core import sweep as _sweep  # sweep imports this module
    res = _sweep.run_sweep(
        problem, [cfg], [gamma], [seed], iters, batch=batch,
        eval_every=eval_every, full_batch=full_batch, w0=w0, w_star=w_star,
        gamma_decay=gamma_decay, backend=backend, device=problem.device)
    return RunResult(
        losses=res.losses[0, 0, 0], bits=res.bits[0, 0, 0],
        w_final=res.w_final[0, 0, 0], w_avg=res.w_avg[0, 0, 0],
        w_tail_avg=res.w_tail_avg[0, 0, 0],
        dist_to_opt=res.dists[0, 0, 0] if w_star is not None else None)


def gamma_max(problem: Problem, cfg: art.ArtemisConfig) -> float:
    """Step-size upper bound from Table 3 / Theorems S5-S6."""
    c_up, c_dwn = cfg.codecs()
    L = problem.smoothness()
    N, p = cfg.n_workers, cfg.p
    wu, wd = c_up.omega, c_dwn.omega
    if cfg.resolved_alpha() == 0.0:   # Thm S5
        return p * N / (L * (wd + 1) * (p * N + 2 * (wu + 1)))
    g1 = 1.0 / ((wd + 1) * (1 + 2.0 / (N * p)) * L)
    g2 = 3.0 / ((wd + 1) * (3 + 8 * (wu + 1) * (N + 2) / (N * p)) * L)
    g3 = N / ((wd + 1) * (N + 4 * (wu + 1) / p - 2) * L)
    return min(g1, g2, g3)
