"""Training losses (reference train.py:103-185; JAX ``train/loss.py``).

Mask-aware: with a mask the mean divides by the masked count, so a caller
that pads gets the unpadded mean.  The port never pads, so its train step
passes no mask and the mean runs over the E real edges.
"""
from __future__ import annotations

import torch.nn.functional as F


def _bce_elementwise(logits, labels, pos_weight):
    """torch ``binary_cross_entropy_with_logits`` with pos_weight:
    ``-[pw * y * log σ(x) + (1-y) * log(1-σ(x))]`` via the stable log-sigmoid."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    return -(pos_weight * labels * log_p + (1.0 - labels) * log_not_p)


def _mean(loss, mask):
    if mask is None:
        return loss.mean()
    return (loss * mask).sum() / mask.sum()


def bce_with_logits(logits, labels, pos_weight=1.0, mask=None):
    """Masked-mean BCE (reference train.py:144)."""
    return _mean(_bce_elementwise(logits, labels, pos_weight), mask)


def symmetry_loss(org_scores, rev_scores, labels, pos_weight=1.0, alpha=1.0,
                  mask=None):
    """BCE(org) + BCE(rev) + alpha * |org - rev|, masked mean
    (reference train.py:103-109)."""
    loss = (_bce_elementwise(org_scores, labels, pos_weight)
            + _bce_elementwise(rev_scores, labels, pos_weight)
            + alpha * (org_scores - rev_scores).abs())
    return _mean(loss, mask)
