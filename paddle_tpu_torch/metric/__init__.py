"""``paddle.metric`` — counterpart of ``paddle_tpu/metric/__init__.py``:
streaming metrics (ref: ``python/paddle/metric/metrics.py``: the
``Metric`` base, ``Accuracy``, ``Precision``, ``Recall``, ``Auc``) that
accumulate over batches in host numpy with the ``reset`` / ``update`` /
``accumulate`` / ``name`` protocol ``hapi.Model.fit`` drives, and the
functional ``accuracy`` / ``auc`` / ``precision_recall`` /
``positive_negative_pair`` (ref: the metric ops), registered in
``OP_REGISTRY`` under the category ``metric``. A Tensor input is read
once to the host (``Tensor.numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, pred, label, *args):
        """Optional pre-processing run inside the program; default identity."""
        return pred, label


class Accuracy(Metric):
    """top-k accuracy (ref: metric.Accuracy; default k=1)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)  # noqa: E741
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l[..., 0]  # noqa: E741
        maxk = max(self.topk)
        top = np.argsort(-p, axis=-1)[..., :maxk]
        return (top == l[..., None]).astype(np.float32)

    def update(self, correct, *args):
        c = _np(correct)
        n = int(np.prod(c.shape[:-1]))
        for i, k in enumerate(self.topk):
            self.total[i] += c[..., :k].sum()
            self.count[i] += n
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """binary precision over 0/1 labels (ref: metric.Precision)."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        l = _np(labels).reshape(-1).astype(np.int64)  # noqa: E741
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return float(self.tp) / d if d else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds).reshape(-1) > 0.5).astype(np.int64)
        l = _np(labels).reshape(-1).astype(np.int64)  # noqa: E741
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return float(self.tp) / d if d else 0.0


class Auc(Metric):
    """ROC AUC via the reference's threshold-bucket approximation
    (ref: metric.Auc, num_thresholds buckets)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        if curve != "ROC":
            raise ValueError("only ROC curve is supported (reference parity)")
        self.num_thresholds = int(num_thresholds)
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]  # probability of the positive class
        p = p.reshape(-1)
        l = _np(labels).reshape(-1).astype(np.int64)  # noqa: E741
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._pos, idx[l == 1], 1)
        np.add.at(self._neg, idx[l == 0], 1)

    def accumulate(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # walk buckets from the highest threshold down
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(_trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """Functional top-k accuracy (ref: paddle.metric.accuracy)."""
    from ..core.tensor import to_tensor
    p = _np(input)
    l = _np(label)  # noqa: E741
    if l.ndim == p.ndim and l.shape[-1] == 1:
        l = l[..., 0]  # noqa: E741
    top = np.argsort(-p, axis=-1)[..., :k]
    acc = (top == l[..., None]).any(-1).mean()
    return to_tensor(np.asarray(acc, np.float32))


# ---------------------------------------------------------------------------
# functional metric ops (ref: auc_op, precision_recall_op,
# positive_negative_pair_op in paddle/fluid/operators/metrics/); the
# stateful accumulators are the Metric classes above
# ---------------------------------------------------------------------------

def auc(input, label, num_thresholds: int = 4095, curve: str = "ROC",  # noqa: A002
        name=None):
    """ref: auc_op — trapezoidal ROC AUC over a threshold histogram.
    ``input [N, 2]`` (prob of class 1 in col 1) or [N] probs."""
    import numpy as _np2
    from ..core.tensor import to_tensor
    p = _np(input)
    y = _np(label).reshape(-1)
    if p.ndim == 2:
        p = p[:, 1]
    bins = _np2.clip((p * num_thresholds).astype(int), 0, num_thresholds)
    pos_h = _np2.bincount(bins[y == 1], minlength=num_thresholds + 1)
    neg_h = _np2.bincount(bins[y != 1], minlength=num_thresholds + 1)
    # descending threshold cumulative
    tp = _np2.cumsum(pos_h[::-1])
    fp = _np2.cumsum(neg_h[::-1])
    tot_p = max(int(tp[-1]), 1)
    tot_n = max(int(fp[-1]), 1)
    tpr = tp / tot_p
    fpr = fp / tot_n
    a = float(_trapezoid(tpr, fpr))
    return to_tensor(_np2.float32(a))


def precision_recall(input, label, num_classes=None, name=None):  # noqa: A002
    """ref: precision_recall_op — per-class and macro/micro
    precision/recall/F1. ``input [N, C]`` scores, ``label [N]``. Returns a
    [C + 2, 3] Tensor: per-class rows then (macro, micro) rows of
    (precision, recall, f1)."""
    import numpy as _np2
    from ..core.tensor import to_tensor
    s = _np(input)
    y = _np(label).reshape(-1)
    C = num_classes or s.shape[1]
    pred = s.argmax(-1)
    rows = []
    tps = fps = fns = 0
    for c in range(C):
        tp = int(((pred == c) & (y == c)).sum())
        fp = int(((pred == c) & (y != c)).sum())
        fn = int(((pred != c) & (y == c)).sum())
        tps, fps, fns = tps + tp, fps + fp, fns + fn
        pr = tp / max(tp + fp, 1)
        rc = tp / max(tp + fn, 1)
        f1 = 2 * pr * rc / max(pr + rc, 1e-12)
        rows.append((pr, rc, f1))
    macro = tuple(float(_np2.mean([r[i] for r in rows])) for i in range(3))
    mpr = tps / max(tps + fps, 1)
    mrc = tps / max(tps + fns, 1)
    micro = (mpr, mrc, 2 * mpr * mrc / max(mpr + mrc, 1e-12))
    return to_tensor(_np2.asarray(rows + [macro, micro], _np2.float32))


def positive_negative_pair(score, label, query_id, name=None):
    """ref: positive_negative_pair_op (ranking eval): within each query,
    count pairs ordered correctly (positive), incorrectly (negative), or
    tied (neutral). Returns (positive, negative, neutral) counts."""
    import numpy as _np2
    from ..core.tensor import to_tensor
    s = _np(score).reshape(-1)
    y = _np(label).reshape(-1)
    q = _np(query_id).reshape(-1)
    pos = neg = neu = 0
    for qid in _np2.unique(q):
        m = q == qid
        ss, yy = s[m], y[m]
        for i in range(len(ss)):
            for j in range(i + 1, len(ss)):
                if yy[i] == yy[j]:
                    continue
                hi, lo = (i, j) if yy[i] > yy[j] else (j, i)
                if ss[hi] > ss[lo]:
                    pos += 1
                elif ss[hi] < ss[lo]:
                    neg += 1
                else:
                    neu += 1
    return (to_tensor(_np2.float32(pos)), to_tensor(_np2.float32(neg)),
            to_tensor(_np2.float32(neu)))


__all__ += ["auc", "precision_recall", "positive_negative_pair"]


def _register_metric_ops():
    from ..core.dispatch import OP_REGISTRY, register_op
    for _n in ["accuracy", "auc", "precision_recall",
               "positive_negative_pair"]:
        _f = globals()[_n]
        if _n not in OP_REGISTRY:
            register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                        differentiable=False, category="metric", public=_f)


_register_metric_ops()
