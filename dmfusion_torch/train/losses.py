"""Loss factory and the quadruplet-KL ("qua") loss.

Port of ``dmfusion/train/losses.py``.  ``make_loss`` selects MSE / L1 /
Criterion (cross-entropy) / KL / qua_loss by the ``schedule.loss``
string.  The semantics kept:
  * the masked cross-entropy is ``(per * m).sum() / max(m.sum(), 1)`` on
    float32 logits, so padded rows of a static-shape batch weigh nothing;
    under a mesh ``m.sum()`` is the whole batch's count, not the shard's,
  * ``_kl_batchmean`` is ``kl_div(..., reduction='batchmean')`` with
    ``0 log 0 := 0`` (the target's log is taken only where it is > 0), and
    its optional ``weights`` make the batch mean a weighted mean,
  * ``qua_loss`` has the same terms, coefficients and zero-coefficient
    short-cuts as dmfusion's.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F


def _kl_batchmean(log_input: torch.Tensor, target: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """sum(target * (log target - log_input)) / batch, with 0 log 0 := 0;
    ``weights`` (B,) turn the batch mean into a weighted mean."""
    pos = target > 0
    safe_log_t = torch.where(pos, torch.log(torch.where(pos, target, 1.0)),
                             0.0)
    pointwise = target * (safe_log_t - log_input)
    if weights is None:
        return pointwise.sum() / log_input.shape[0]
    w = weights.to(pointwise.dtype)
    return (pointwise.sum(dim=-1) * w).sum() / w.sum().clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean integer-label CE; with ``mask`` the mean over the real rows.

    ``count`` replaces the mask's own count as the denominator: a rank's
    shard of a batch divides by the whole batch's real rows, so the ranks'
    losses, and their gradients, sum to the whole batch's.  A mean of the
    ranks' own means would weigh a row of a shard with fewer real rows
    (the padded last batch's) more."""
    per = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype)
    n = m.sum() if count is None else count.to(per.dtype)
    return (per * m).sum() / n.clamp(min=1.0)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def kl(log_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _kl_batchmean(log_pred, target)


def qua_loss(out: torch.Tensor, bs: int, targets: torch.Tensor,
             cfg: Mapping[str, Any],
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Quadruplet KL loss over 4-stream concatenated logits (4*bs, C);
    ``mask`` (bs,) excludes padded rows from every batch mean."""
    d = cfg["dqtl"]
    eps = d["epsilon"]
    tao = d["tao"]
    alpha, beta, gamma = d["alpha"], d["beta"], d["gamma"]

    data = torch.softmax(out, dim=-1)
    p, q, r, s = (data[:bs], data[bs:2 * bs], data[2 * bs:3 * bs],
                  data[3 * bs:4 * bs])

    def term(x, y):
        return _kl_batchmean(torch.log(x + eps), y, mask)

    loss = torch.zeros((), dtype=torch.float32, device=out.device)
    if alpha != 0:
        kl_m_p = term(q, p)
        kl_m_gm = term(r, p)
        kl_m_gp = term(s, p)
        kl_p_m = term(p, q)
        kl_p_gp = term(r, q)
        kl_p_gm = term(s, q)
        l1_ = kl_m_p + kl_m_gm + torch.abs(kl_m_gp - kl_m_gm + tao)
        l2_ = kl_p_m + kl_p_gp + torch.abs(kl_p_gm - kl_p_gp + tao)
        loss = loss + alpha * (l1_ + l2_)
    if beta != 0:
        kl_m_gp = term(s, p)
        kl_p_gm = term(s, q)
        bal = (torch.exp(-torch.abs(kl_m_gp / p)) +
               torch.exp(-torch.abs(kl_p_gm / q)))
        if mask is None:
            l3_ = torch.mean(bal)
        else:
            w = mask.to(bal.dtype)[:, None]
            l3_ = (bal * w).sum() / (w.sum() * bal.shape[-1]).clamp(min=1.0)
        loss = loss + beta * l3_
    # Classification term: KL(softmax(p+q) || softmaxed one-hot labels).
    onehot = F.one_hot(targets.long(), out.shape[-1]).to(out.dtype)
    soft_label = torch.softmax(onehot, dim=-1)
    pq = torch.log_softmax(p + q, dim=-1)
    l4_ = _kl_batchmean(pq, soft_label, mask)
    return loss + gamma * l4_


def make_loss(loss_type: str, cfg: Mapping[str, Any]) -> Callable:
    if loss_type == "MSE":
        return mse
    if loss_type == "L1":
        return l1
    if loss_type == "Criterion":
        return cross_entropy
    if loss_type == "KL":
        return kl
    if loss_type == "qua_loss":
        return lambda out, bs, t, c=cfg, mask=None: qua_loss(out, bs, t, c,
                                                             mask)
    raise ValueError(f"unknown loss {loss_type!r}")
