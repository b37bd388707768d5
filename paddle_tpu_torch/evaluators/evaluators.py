"""Evaluator implementations (``paddle_tpu/evaluators/evaluators.py``;
reference gserver/evaluators/Evaluator.cpp + ChunkEvaluator.cpp +
CTCErrorEvaluator.cpp).

Contract, as in the JAX package:
  ev.init() -> state
  ev.update(state, **batch outputs) -> state
  ev.result(state) -> float | dict

Where JAX keeps the state as device arrays (the additive counters of
``ClassificationError``, ``SumEvaluator``, ``ColumnSum``, ``Auc``,
``PrecisionRecall``), the state here is float32 tensors that move to the
device of the first batch they see (the trainer's) and stay there:
``update`` is tensor arithmetic with no host sync, and only ``result``
reads them back.  ``PnPair``, ``ChunkEvaluator`` and ``CTCError``
accumulate on the host in numpy, as JAX's do.
"""

import numpy as np
import torch


def _host(x):
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(t, like):
    """State tensor ``t`` on ``like``'s device (a no-op once there)."""
    return t if t.device == like.device else t.to(like.device)


def _f32(x):
    return x.to(torch.float32)


class Evaluator:
    name = "evaluator"

    def init(self):
        raise NotImplementedError

    def update(self, state, **kw):
        raise NotImplementedError

    def result(self, state):
        raise NotImplementedError


class ClassificationError(Evaluator):
    """Reference ClassificationErrorEvaluator: fraction of rows whose
    argmax != label (with optional per-row weight)."""
    name = "classification_error"

    def init(self):
        return {"wrong": torch.zeros(()), "total": torch.zeros(())}

    def update(self, state, pred=None, label=None, weight=None, mask=None):
        ids = torch.argmax(pred, dim=-1)
        lab = label.reshape(ids.shape)
        err = _f32(ids != lab)
        w = torch.ones_like(err) if weight is None \
            else _f32(weight.reshape(err.shape))
        if mask is not None:
            w = w * _f32(mask.reshape(err.shape))
        return {"wrong": _on(state["wrong"], err) + torch.sum(err * w),
                "total": _on(state["total"], err) + torch.sum(w)}

    def result(self, state):
        t = float(state["total"])
        return float(state["wrong"]) / t if t else 0.0


class SumEvaluator(Evaluator):
    name = "sum"

    def init(self):
        return {"sum": torch.zeros(()), "total": torch.zeros(())}

    def update(self, state, value=None, weight=None, **_):
        # sequence-valued inputs (e.g. crf_decoding error indicators): sum
        # valid positions only
        if hasattr(value, "lengths"):
            d = value.data.reshape(value.data.shape[0],
                                   value.data.shape[1], -1)
            d = d * value.mask(d.dtype)[..., None]
            value = d.reshape(d.shape[0], -1).sum(-1)
        w = torch.ones(value.shape[0], device=value.device) \
            if weight is None else _f32(weight.reshape(-1))
        rows = _f32(value.reshape(value.shape[0], -1).sum(-1))
        return {"sum": _on(state["sum"], rows) + torch.sum(rows * w),
                "total": _on(state["total"], rows) + torch.sum(w)}

    def result(self, state):
        return float(state["sum"])


class ColumnSum(Evaluator):
    name = "column_sum"

    def __init__(self, size):
        self.size = size

    def init(self):
        return {"sum": torch.zeros((self.size,)), "total": torch.zeros(())}

    def update(self, state, value=None, weight=None, **_):
        value = _f32(value)
        w = torch.ones(value.shape[0], device=value.device) \
            if weight is None else _f32(weight.reshape(-1))
        return {"sum": _on(state["sum"], value)
                + torch.sum(value * w[:, None], dim=0),
                "total": _on(state["total"], value) + torch.sum(w)}

    def result(self, state):
        return _host(state["sum"])


class Auc(Evaluator):
    """Reference AucEvaluator: histogram-bucketed ROC AUC (the reference
    uses a fixed-resolution discretization too)."""
    name = "auc"

    def __init__(self, buckets=1024):
        self.buckets = buckets

    def init(self):
        return {"pos": torch.zeros((self.buckets,)),
                "neg": torch.zeros((self.buckets,))}

    def update(self, state, pred=None, label=None, weight=None, **_):
        # pred: [B, 2] softmax or [B, 1]/[B] positive-class prob
        p = pred[:, 1] if (pred.ndim == 2 and pred.shape[1] == 2) \
            else pred.reshape(-1)
        lab = _f32(label.reshape(-1))
        w = torch.ones_like(lab) if weight is None \
            else _f32(weight.reshape(-1))
        # JAX's index: p * buckets in p's dtype (a power-of-two product,
        # exact), truncated toward zero to int32, then clipped, so a
        # probability on a bucket edge lands in the same bucket
        idx = torch.clamp((p * self.buckets).to(torch.int32), 0,
                          self.buckets - 1)
        pos = _on(state["pos"], lab).index_add(0, idx, lab * w)
        neg = _on(state["neg"], lab).index_add(0, idx, (1 - lab) * w)
        return {"pos": pos, "neg": neg}

    def result(self, state):
        pos = _host(state["pos"])[::-1]  # descending threshold
        neg = _host(state["neg"])[::-1]
        tp = np.cumsum(pos)
        fp = np.cumsum(neg)
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.5
        # trapezoid over ROC points (np.trapz before numpy 2)
        tpr = np.concatenate([[0.0], tp / tot_pos])
        fpr = np.concatenate([[0.0], fp / tot_neg])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))


class PrecisionRecall(Evaluator):
    """Reference PrecisionRecallEvaluator: per-class TP/FP/FN -> macro F1
    (or binary stats when positive_label given)."""
    name = "precision_recall"

    def __init__(self, num_classes, positive_label=None):
        self.num_classes = num_classes
        self.positive_label = positive_label

    def init(self):
        n = self.num_classes
        return {"tp": torch.zeros((n,)), "fp": torch.zeros((n,)),
                "fn": torch.zeros((n,))}

    def update(self, state, pred=None, label=None, **_):
        ids = torch.argmax(pred, dim=-1)
        lab = label.reshape(ids.shape).to(torch.int32)
        classes = torch.arange(self.num_classes, device=ids.device)
        # jax.nn.one_hot: a row of zeros for an id outside [0, n)
        oh_pred = _f32(ids[:, None] == classes)
        oh_lab = _f32(lab[:, None] == classes)
        tp = torch.sum(oh_pred * oh_lab, dim=0)
        fp = torch.sum(oh_pred * (1 - oh_lab), dim=0)
        fn = torch.sum((1 - oh_pred) * oh_lab, dim=0)
        return {"tp": _on(state["tp"], tp) + tp,
                "fp": _on(state["fp"], tp) + fp,
                "fn": _on(state["fn"], tp) + fn}

    def result(self, state):
        tp, fp, fn = (_host(state[k]) for k in ("tp", "fp", "fn"))
        if self.positive_label is not None:
            i = self.positive_label
            prec = tp[i] / max(tp[i] + fp[i], 1e-9)
            rec = tp[i] / max(tp[i] + fn[i], 1e-9)
            f1 = 2 * prec * rec / max(prec + rec, 1e-9)
            return {"precision": float(prec), "recall": float(rec),
                    "f1": float(f1)}
        prec = tp / np.maximum(tp + fp, 1e-9)
        rec = tp / np.maximum(tp + fn, 1e-9)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
        return {"macro_f1": float(f1.mean()),
                "precision": float(prec.mean()), "recall": float(rec.mean())}


class PnPair(Evaluator):
    """Reference PnpairEvaluator: counts correctly-ordered (pos before
    neg) prediction pairs within query groups.  Host-side accumulation,
    as in JAX."""
    name = "pnpair"

    def init(self):
        return {"records": []}

    def update(self, state, pred=None, label=None, query_id=None, **_):
        p = _host(pred).reshape(-1)
        l = _host(label).reshape(-1)
        q = _host(query_id).reshape(-1) if query_id is not None \
            else np.zeros_like(l)
        state["records"].append((p, l, q))
        return state

    def result(self, state):
        if not state["records"]:
            return 0.0
        p = np.concatenate([r[0] for r in state["records"]])
        l = np.concatenate([r[1] for r in state["records"]])
        q = np.concatenate([r[2] for r in state["records"]])
        pos_cnt = neg_cnt = spe = 0.0
        for qid in np.unique(q):
            m = q == qid
            pi, li = p[m], l[m]
            diff_l = li[:, None] - li[None, :]
            diff_p = pi[:, None] - pi[None, :]
            pairs = diff_l > 0
            pos_cnt += np.sum(pairs & (diff_p > 0))
            neg_cnt += np.sum(pairs & (diff_p < 0))
            spe += np.sum(pairs & (diff_p == 0))
        denom = neg_cnt + spe / 2.0
        return float(pos_cnt / max(denom, 1e-9))


class RankAuc(Auc):
    name = "rankauc"


class ChunkEvaluator(Evaluator):
    """Reference ChunkEvaluator.cpp: chunk (NER span) F1 over plain/IOB/
    IOE/IOBES tagging — the exact isChunkBegin/isChunkEnd state machine
    (ChunkEvaluator.cpp:186-245).  Host-side decode of spans.

    Label encoding (reference :33-35): tag = label % numTagTypes,
    chunk type = label // numTagTypes; label == numChunkTypes*numTagTypes
    is the 'other' (O) tag."""
    name = "chunk"

    _SCHEMES = {
        #            nTag  B   I   E   S
        "IOB":       (2,   0,  1, -1, -1),
        "IOE":       (2,  -1,  0,  1, -1),
        "IOBES":     (4,   0,  1,  2,  3),
        "plain":     (1,  -1, -1, -1, -1),
    }

    def __init__(self, scheme="IOB", num_chunk_types=None,
                 excluded_chunk_types=()):
        if scheme not in self._SCHEMES:
            raise ValueError(f"unknown chunk scheme {scheme!r} "
                             f"(have {sorted(self._SCHEMES)})")
        self.scheme = scheme
        self.num_chunk_types = num_chunk_types
        self.excluded = set(excluded_chunk_types)

    def init(self):
        return {"correct": 0, "pred": 0, "gold": 0}

    def _segments(self, tags, num_chunk_types):
        n_tag, t_b, t_i, t_e, t_s = self._SCHEMES[self.scheme]
        other = num_chunk_types

        def is_end(ptag, ptype, tag, typ):
            if ptype == other:
                return False
            if typ == other or typ != ptype:
                return True
            if ptag in (t_e, t_s):
                return True
            if ptag in (t_b, t_i):
                return tag in (t_b, t_s)
            return False

        def is_begin(ptag, ptype, tag, typ):
            if ptype == other:
                return typ != other
            if typ == other:
                return False
            if typ != ptype or tag == t_b or tag == t_s:
                return True
            if tag in (t_i, t_e):
                return ptag in (t_e, t_s)
            return False

        segments = []
        start, in_chunk = 0, False
        tag, typ = -1, other
        for i, lab in enumerate(tags):
            if lab < 0:        # negative padding without lengths=: stop
                tags = tags[:i]
                break
            ptag, ptype = tag, typ
            tag, typ = lab % n_tag, lab // n_tag
            if in_chunk and is_end(ptag, ptype, tag, typ):
                segments.append((start, i - 1, ptype))
                in_chunk = False
            if is_begin(ptag, ptype, tag, typ):
                start, in_chunk = i, True
        if in_chunk:
            segments.append((start, len(tags) - 1, typ))
        return {s for s in segments if s[2] not in self.excluded}

    def _num_types(self):
        if self.num_chunk_types is None:
            # the reference REQUIRES num_chunk_types (ChunkEvaluator.cpp:108
            # CHECK); inferring it from data is ambiguous because the same
            # max label can be a typed tag or the O tag
            raise ValueError("ChunkEvaluator needs num_chunk_types= "
                             "(reference chunk evaluator config field)")
        return self.num_chunk_types

    def update(self, state, pred=None, label=None, lengths=None, **_):
        p = _host(pred)
        l = _host(label)
        lens = _host(lengths) if lengths is not None else \
            np.full(p.shape[0], p.shape[1])
        nct = self._num_types()
        for i in range(p.shape[0]):
            ps = self._segments(list(p[i, :lens[i]]), nct)
            gs = self._segments(list(l[i, :lens[i]]), nct)
            state["correct"] += len(ps & gs)
            state["pred"] += len(ps)
            state["gold"] += len(gs)
        return state

    def result(self, state):
        prec = state["correct"] / max(state["pred"], 1e-9)
        rec = state["correct"] / max(state["gold"], 1e-9)
        return {"precision": prec, "recall": rec,
                "f1": 2 * prec * rec / max(prec + rec, 1e-9)}


class CTCError(Evaluator):
    """Reference CTCErrorEvaluator: edit distance between greedy-decoded
    output and label, normalized by label length.  Host-side."""
    name = "ctc_error"

    def init(self):
        return {"dist": 0.0, "len": 0.0}

    @staticmethod
    def _edit_distance(a, b):
        dp = np.arange(len(b) + 1, dtype=np.int32)
        for i in range(1, len(a) + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, len(b) + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (a[i - 1] != b[j - 1]))
        return int(dp[-1])

    def update(self, state, decoded=None, decoded_lengths=None, label=None,
               label_lengths=None, **_):
        d = _host(decoded)
        dl = _host(decoded_lengths)
        l = _host(label)
        ll = _host(label_lengths)
        for i in range(d.shape[0]):
            state["dist"] += self._edit_distance(
                list(d[i, :dl[i]]), list(l[i, :ll[i]]))
            state["len"] += float(ll[i])
        return state

    def result(self, state):
        return state["dist"] / max(state["len"], 1e-9)


_REGISTRY = {
    "classification_error": ClassificationError,
    "sum": SumEvaluator,
    "column_sum": ColumnSum,
    "auc": Auc,
    "rankauc": RankAuc,
    "precision_recall": PrecisionRecall,
    "pnpair": PnPair,
    "chunk": ChunkEvaluator,
    "ctc_error": CTCError,
}


def get(name, **kw):
    try:
        return _REGISTRY[name](**kw)
    except KeyError:
        raise KeyError(f"unknown evaluator {name!r}; have {sorted(_REGISTRY)}")
