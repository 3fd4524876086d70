"""The loss the fused train step minimizes.

The port's counterpart of the fused half of
``veles_tpu/znicz/evaluator.py``: the masked softmax cross-entropy on
logits (``EvaluatorSoftmax.loss_from_logits``).  The fused step keeps
the evaluator's metrics itself (n_err, confusion matrix, max error row
sum; :mod:`.fused`).  The evaluator units of graph mode
(``EvaluatorSoftmax.run``, ``EvaluatorMSE``) are not ported yet.
"""

import torch

__all__ = ["EvaluatorSoftmax"]


class EvaluatorSoftmax:
    """Cross-entropy evaluation for All2AllSoftmax heads."""

    @staticmethod
    def loss_from_logits(logits, labels, mask):
        """Numerically-stable masked softmax cross-entropy: the mean of
        ``-log softmax(logits)[label]`` over the rows where ``mask`` is
        1 (padded rows of a short minibatch carry 0)."""
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
