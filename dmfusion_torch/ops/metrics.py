"""Classification metrics: confusion matrix -> OA/AA/kappa, class maps.

Port of ``dmfusion/ops/metrics.py``, with the reference semantics:
  * the confusion matrix is indexed ``[pred][target]``
    (solver/mainsolver.py:139-141),
  * per-class accuracy divides the diagonal by the *column* sum and
    **skips class 0** (background) in AA and OA (indicators/kappa.py:69-84),
  * Cohen's kappa is computed over the full matrix including class 0
    (indicators/kappa.py:10-22),
  * a class map is a palette lookup per pixel.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) preds + (N,) integer targets -> (C, C) float32 matrix[pred][target]."""
    idx = pred.to(torch.int64) * num_classes + target.to(torch.int64)
    weights = (torch.ones_like(idx, dtype=torch.float32) if mask is None
               else mask.to(torch.float32))
    flat = torch.bincount(idx, weights=weights, minlength=num_classes ** 2)
    return flat.to(torch.float32).reshape(num_classes, num_classes)


def kappa(matrix) -> float:
    """Cohen's kappa over the full matrix (incl. class 0)."""
    m = np.asarray(matrix, dtype=np.float64)
    n = m.sum()
    po = np.trace(m) / n
    pe = (m.sum(axis=1) * m.sum(axis=0)).sum() / (n * n)
    return float((po - pe) / (1 - pe))


def aa_oa(matrix) -> list:
    """Return ``[aa, oa, kappa, per_class_rows]``;
    ``per_class_rows[i] = [overall, correct, accuracy]`` for class ``i+1``.
    Class 0 is excluded from AA/OA; kappa sees the full matrix."""
    m = np.asarray(matrix, dtype=np.float64)
    col = m.sum(axis=0)  # true count per class (matrix is [pred][target])
    rows = []
    correct = 0.0
    accs = []
    for i in range(1, m.shape[0]):
        acc = m[i, i] / col[i] if col[i] > 0 else 0.0
        rows.append([float(col[i]), float(m[i, i]), float(acc)])
        accs.append(acc)
        correct += m[i, i]
    aa = float(np.mean(accs)) if accs else 0.0
    total = col.sum()
    oa = float(correct / total) if total > 0 else 0.0
    return [aa, oa, kappa(m), rows]


def per_stream_results(matrices: list) -> list[list]:
    """``aa_oa`` of each DQTL stream's confusion matrix, scored on its own
    (the reference's ``indicator_SCLN``, indicators/kappa.py:211-213)."""
    return [aa_oa(m) for m in matrices]


def render_class_map(labels: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """(H, W) class ids + (C, 3) palette -> (H, W, 3) uint8 image."""
    return palette.to(torch.uint8)[labels.to(torch.int64)]
