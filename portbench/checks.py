"""The numbers that decide ``correct``, each comparing what the program
produced with what the plain reference computes from the same inputs.

* ``label_gap``: for each served label, how far the reference's logit of
  that label lies below the reference's best logit of the same anchor;
  the widest over every label compared.  Zero where the program picked
  the reference's argmax; small where it picked a near tie, as rounding
  may; large where it served a wrong class.
* ``logit_gap``: the widest ``|logit_prog - logit_ref|`` over every
  logit of a request or map the program computed on its way to the
  labels, over the standard deviation of the reference's logits of the
  same request or map; the widest over those compared.  It sees what a
  label cannot: a logit moved by less than its anchor's margin, and
  near-flat logits, where a wrong label costs little ``label_gap``.
* Training, per parameter tensor (leaf), for a quantity ``x`` (the
  first step's gradient, or the parameters' change over the first steps):
  ``| |x_prog| - |x_ref| | / max(|x_ref|, median leaf's |x_ref|)``
  (Frobenius norms), taken at the worst leaf (``grad_gap``,
  ``delta_gap``) or the median leaf (``grad_gap_median``).  The change
  leaves out leaves whose reference gradient is under a thousandth of the
  median leaf's: those move under Adam by rounding alone.
* ``grad_elem_median``: the median, over every element of the first
  step's gradient, of ``|g_prog - g_ref| / |g_ref|``.  A leaf's norm is
  blind to rounding that is as often up as down, which is what a lower
  precision adds; an element's gap is not.  How far rounding moves a
  seed's gradient differs from seed to seed (some read 4x the others,
  whatever the precision), so ``grad_elem_vs_bf16`` states it over the
  same gap of the reference's first step computed in bfloat16 (every
  product's operands and gradients rounded), the configurations'
  compute dtype: steady from seed to seed, and independent of the
  float8 control.
* ``loss1_gap``: the relative gap of the first step's loss; ``loss_gap``
  the widest over the first steps.

Which of them a cell compares, and the readings each limit was set from,
is in ``portbench/limits/<cell>.json`` and PERF.md.
"""

from __future__ import annotations

import statistics
from typing import Mapping

import torch

#: A leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of the parameters' change.
STILL_LEAF = 1e-3


def label_gap(ref_logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Widest ``best - logit[label]`` over the rows of ``(..., classes)``
    reference logits and the served labels of the same shape as their
    leading dims.  A label outside the classes reads infinite."""
    labels = labels.to(ref_logits.device).long()
    classes = ref_logits.shape[-1]
    if labels.numel() and (labels.min() < 0 or labels.max() >= classes):
        return float("inf")
    best = ref_logits.max(dim=-1).values
    served = ref_logits.gather(-1, labels[..., None])[..., 0]
    return float((best - served).max())


def logit_gap(prog, ref_logits: torch.Tensor) -> float:
    """Widest ``|prog - ref|`` over the reference logits' standard
    deviation; infinite where the program's logits are missing or of
    another shape."""
    if prog is None or tuple(prog.shape) != tuple(ref_logits.shape):
        return float("inf")
    gap = (prog.to(ref_logits.device).float() - ref_logits).abs().max()
    return float(gap / ref_logits.std())


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def norms(tree: Mapping[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              keep=None) -> dict[str, float]:
    """Each leaf's ``| |prog| - |ref| | / max(|ref|, median |ref|)``."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def moving_leaves(grad_ref: Mapping[str, float]) -> set[str]:
    med = statistics.median(grad_ref.values())
    return {k for k, v in grad_ref.items() if v >= STILL_LEAF * med}


def element_gap(prog: Mapping[str, torch.Tensor],
                ref: Mapping[str, torch.Tensor]) -> float:
    """The median over every element of every leaf of ``|prog - ref| /
    |ref|``."""
    p = torch.cat([prog[k].detach().reshape(-1).double() for k in ref])
    r = torch.cat([ref[k].detach().reshape(-1).double() for k in ref])
    return float(((p - r).abs() / r.abs()).nan_to_num(0.0).median())


def train_gaps(prog: dict, ref: dict, norm: dict) -> dict[str, float]:
    """``prog``, ``ref`` and ``norm`` (the reference's first step computed
    in bfloat16): ``losses`` (first steps), ``grad`` and ``delta`` (leaf
    norms of the first step's gradient and of the parameters' change over
    the first steps) and ``grad_tensors`` (the first step's gradient).  The
    numbers a limit is set on, and those whose readings showed why not
    (``portbench/limits/``, PERF.md)."""
    grad = leaf_gaps(prog["grad"], ref["grad"])
    delta = leaf_gaps(prog["delta"], ref["delta"], moving_leaves(ref["grad"]))
    elem = element_gap(prog["grad_tensors"], ref["grad_tensors"])
    return {"loss1_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "delta_gap": max(delta.values()),
            "grad_elem_median": elem,
            "grad_elem_vs_bf16": elem / element_gap(
                norm["grad_tensors"], ref["grad_tensors"])}
