"""Training losses.

Counterpart of ``multipitch_architectures_tpu/train/losses.py``. The
experiments use two criteria (SURVEY §2.8):

- BCE on sigmoid pitch salience (torch.nn.BCELoss(reduction='mean'),
  exp180d…py:92);
- multitask BCE + CrossEntropy/25 for the PUnet family, where the
  polyphony target is the count of active pitch bins
  (exp195f…py:330-333).

``bce_loss`` follows the JAX package, not ``nn.BCELoss``: it clips p to
[1e-7, 1 - 1e-7] (no gradient beyond the clip), where ``nn.BCELoss``
clamps each log at -100 and keeps a gradient. The two agree inside the
clip.
"""

import torch
import torch.nn.functional as F

EPS = 1e-7


def _weighted_mean(elem, weights):
    if weights is None:
        return elem.mean()
    w = weights.reshape((-1,) + (1,) * (elem.dim() - 1))
    return (elem * w).sum() / (w.sum() * elem[0].numel())


def bce_loss(y_pred, y_true, weights=None):
    """Mean binary cross-entropy over all elements (natural log), with
    optional per-sample ``weights`` (B,)."""
    p = y_pred.clamp(EPS, 1.0 - EPS)
    elem = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))
    return _weighted_mean(elem, weights)


def polyphony_targets(y_true):
    """Polyphony class target = number of active pitches in the center
    frame (exp195f…py:331): y_true (B, 1, 1, bins) -> int64 (B, 1, 1)."""
    return y_true.sum(dim=-1).long()


def cross_entropy_logits(logits, labels, weights=None, strict=False):
    """torch.nn.CrossEntropyLoss(reduction='mean') on (B, C, *spatial)
    logits with integer labels (B, *spatial).

    An out-of-range label (a frame whose polyphony exceeds the head's
    classes), on which torch's own loss fails with a device assert, is
    clipped to the top class (``strict=False``) or turns the loss into NaN
    (``strict=True``), which the trainer's NaN stop then catches — as in
    the JAX package.
    """
    logp = F.log_softmax(logits, dim=1)
    labels_c = labels.clamp(0, logits.shape[1] - 1)
    picked = torch.gather(logp, 1, labels_c[:, None])[:, 0]
    if strict:
        picked = torch.where(labels == labels_c, picked,
                             torch.full_like(picked, float("nan")))
    return -_weighted_mean(picked, weights)


def multitask_bce_ce_loss(outputs, y_true, weights=None,
                          polyphony_weight=1.0 / 25.0):
    """loss1 + loss2/25 of the PUnet experiments (exp195f…py:332-333).

    outputs: (y_pred (B, 1, 1, bins), n_pred (B, steps, Ht, Wt))."""
    y_pred, n_pred = outputs
    n_target = polyphony_targets(y_true)               # (B, 1, 1)
    loss1 = bce_loss(y_pred, y_true, weights)
    loss2 = cross_entropy_logits(n_pred, n_target, weights)
    return loss1 + polyphony_weight * loss2
