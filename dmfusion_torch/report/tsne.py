"""Exact t-SNE in plain torch, on the caller's device.

dmfusion's ``embedding_scatter`` embeds with sklearn's ``TSNE(n_components=2,
random_state=seed, init="pca")``; the machine with the card has no sklearn,
so the port embeds with this module.  It keeps the defaults that call
resolves to in sklearn 1.9:
  * perplexity 30: each point's Gaussian bandwidth is found by sklearn's
    binary search (100 steps at most, entropy within 1e-5) on the squared
    Euclidean distances rounded to float32, as sklearn rounds them, and the
    conditionals are symmetrised into the joint ``P``;
  * early exaggeration 12 for the first 250 iterations at momentum 0.5,
    then momentum 0.8 with fresh gains and update, 1000 iterations in all;
  * learning rate ``max(N / 12 / 4, 50)``; per-element gains +0.2 where the
    gradient turns against the last update, else x0.8, floored at 0.01;
    every 50 iterations the KL is checked: the run stops after 300
    iterations without progress (250 while exaggerating) or at a gradient
    norm of 1e-7;
  * initialisation by the 2-component PCA (signs as sklearn's ``svd_flip``
    fixes them), scaled so that column 0 has standard deviation 1e-4;
  * Student-t kernel with one degree of freedom.

Deviation: sklearn's default method is Barnes-Hut; this gradient is exact,
over every pair.  The N x N matrices suit the diagnostics' N (at most
``visualize.samples``, 2000).  Everything is float64, whatever the input's
dtype; sklearn keeps the embedding in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

MACHINE_EPSILON = float(torch.finfo(torch.float64).eps)
# sklearn's binary search holds these as C floats.
_SUM_FLOOR = float(torch.tensor(1e-8, dtype=torch.float32))
_ENTROPY_TOL = float(torch.tensor(1e-5, dtype=torch.float32))
SEARCH_STEPS = 100
PERPLEXITY = 30.0
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7


class Embedding(NamedTuple):
    """A t-SNE run: the (N, 2) float64 embedding, the KL divergence of the
    last checked iteration (sklearn's ``kl_divergence_``), the last
    iteration's index (``n_iter_``) and the joint probabilities ``p``
    ((N, N), diagonal 0)."""
    xy: torch.Tensor
    kl_divergence: float
    n_iter: int
    p: torch.Tensor


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, N) float64 squared Euclidean distances, as sklearn's
    ``euclidean_distances(squared=True)`` forms them: ``|a|^2 + |b|^2 -
    2 a.b``, clipped at 0, the diagonal 0."""
    x = x.to(torch.float64)
    sq = (x * x).sum(dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return d.clamp_(min=0.0).fill_diagonal_(0.0)


def _conditionals(d: torch.Tensor, beta: torch.Tensor, off: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    p = torch.exp(-d * beta[:, None]) * off
    s = p.sum(dim=1)
    s = torch.where(s == 0, _SUM_FLOOR, s)
    return p / s[:, None], s


def joint_probabilities(d: torch.Tensor) -> torch.Tensor:
    """(N, N) squared distances -> the (N, N) joint probabilities of
    sklearn's ``_joint_probabilities`` (its condensed vector, mirrored; the
    diagonal 0).  Every row runs sklearn's binary search on its precision
    ``beta`` (from 1: doubled or halved until bracketed, then bisected),
    all rows at once; a row stops, with the conditional of that step, once
    its entropy is within tolerance of ``log(PERPLEXITY)``."""
    d = d.to(torch.float32).to(torch.float64)
    n = d.shape[0]
    off = 1.0 - torch.eye(n, dtype=torch.float64, device=d.device)
    want = math.log(PERPLEXITY)
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    live = torch.ones(n, dtype=torch.bool, device=d.device)
    used = beta.clone()  # the precision of each row's last conditional
    for _ in range(SEARCH_STEPS):
        p, s = _conditionals(d, beta, off)
        diff = torch.log(s) + beta * (d * p).sum(dim=1) - want
        used = torch.where(live, beta, used)
        live = live & (diff.abs() > _ENTROPY_TOL)
        if not bool(live.any()):
            break
        up = diff > 0
        step = torch.where(up, torch.where(hi == math.inf, beta * 2.0,
                                           (beta + hi) / 2.0),
                           torch.where(lo == -math.inf, beta / 2.0,
                                       (beta + lo) / 2.0))
        lo = torch.where(live & up, beta, lo)
        hi = torch.where(live & ~up, beta, hi)
        beta = torch.where(live, step, beta)
    cond, _ = _conditionals(d, used, off)
    p = cond + cond.T
    p = p / p.sum().clamp(min=MACHINE_EPSILON)
    return p.clamp(min=MACHINE_EPSILON) * off


def kl_divergence(y: torch.Tensor, p: torch.Tensor,
                  compute_error: bool = True
                  ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """sklearn's ``_kl_divergence`` (one degree of freedom) of the (N, 2)
    embedding ``y`` against the square joint ``p``: (the KL divergence, or
    None without ``compute_error``; the (N, 2) gradient)."""
    sq = (y * y).sum(dim=1)
    # 1 / (1 + |y_i - y_j|^2), in place over one (N, N) buffer; the
    # expanded square's rounding is far below the 1 it is added to.
    num = torch.addmm(sq[:, None] + sq[None, :], y, y.T, alpha=-2.0)
    num.add_(1.0).reciprocal_().fill_diagonal_(0.0)
    q = torch.div(num, num.sum()).clamp_(min=MACHINE_EPSILON)
    kl = None
    if compute_error:
        kl = (p * torch.log(p.clamp(min=MACHINE_EPSILON) / q)).sum()
    pqd = torch.sub(p, q, out=q).mul_(num)
    grad = (pqd.sum(dim=1)[:, None] * y).sub_(pqd @ y).mul_(4.0)
    return kl, grad


def gradient_descent(y: torch.Tensor, p: torch.Tensor, it: int,
                     max_iter: int, *, momentum: float, learning_rate: float,
                     n_iter_without_progress: int,
                     n_iter_check: int = N_ITER_CHECK
                     ) -> tuple[torch.Tensor, float, int]:
    """sklearn's ``_gradient_descent`` on :func:`kl_divergence`, from
    iteration ``it`` up to ``max_iter``: -> (embedding, the last computed
    KL, the last iteration).  The KL is computed, and the stopping rules
    read on the host, every ``n_iter_check`` iterations and at the last."""
    y = y.clone()
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(torch.finfo(torch.float64).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % n_iter_check == 0
        kl, grad = kl_divergence(y, p, check or i == max_iter - 1)
        gains = torch.where(update * grad < 0.0, gains + 0.2,
                            gains * 0.8).clamp_(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if kl is not None:
            error = float(kl)
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= MIN_GRAD_NORM:
                break
    return y, error, i


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """The (N, 2) float64 start: the centred data on its first two
    principal axes, each axis's largest loading made positive (sklearn's
    ``svd_flip``), scaled so that column 0 has standard deviation 1e-4."""
    x = x.to(torch.float64)
    xc = x - x.mean(dim=0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    v = vt[:2]
    pick = v.abs().argmax(dim=1)
    v = v * torch.sign(v[torch.arange(v.shape[0], device=v.device), pick]
                       )[:, None]
    y = xc @ v.T
    return y / y[:, 0].std(correction=0) * 1e-4


def tsne(x: torch.Tensor) -> Embedding:
    """Embed the (N, D) rows of ``x`` in 2-D, on ``x``'s device, as
    sklearn's ``TSNE(n_components=2, init="pca", method="exact")`` does
    (module docstring)."""
    n = x.shape[0]
    if PERPLEXITY >= n:
        raise ValueError(f"perplexity ({PERPLEXITY}) must be less than the "
                         f"number of points ({n})")
    p = joint_probabilities(squared_distances(x))
    y = pca_init(x)
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    p = p * EARLY_EXAGGERATION
    y, kl, it = gradient_descent(
        y, p, 0, EXPLORATION_ITER, momentum=0.5, learning_rate=lr,
        n_iter_without_progress=EXPLORATION_ITER)
    p = p / EARLY_EXAGGERATION
    y, kl, it = gradient_descent(
        y, p, it + 1, MAX_ITER, momentum=0.8, learning_rate=lr,
        n_iter_without_progress=N_ITER_WITHOUT_PROGRESS)
    return Embedding(y, kl, it, p)
