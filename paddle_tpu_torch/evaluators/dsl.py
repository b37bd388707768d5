"""Evaluator DSL ctors (``paddle_tpu/evaluators/dsl.py``; the
reference's trainer_config_helpers/evaluators.py surface:
@evaluator-decorated config functions wiring REGISTER_EVALUATOR'd C++
evaluators, Evaluator.cpp:172-1346).

Each ctor returns an EvaluatorSpec binding an evaluator implementation
(``evaluators.evaluators``: additive tensor state on the trainer's
device, or host state) to graph layers; the trainer fetches the bound
layers every batch, updates the state, and logs ``result()`` every
log_period and at pass end — the reference's print flow.

Printer evaluators print host-side (the reference's printer evaluators
are likewise host prints in Evaluator.cpp)."""

import numpy as np

from paddle_tpu_torch.evaluators import evaluators as ev_impls
from paddle_tpu_torch.evaluators.evaluators import _host

__all__ = [
    "EvaluatorSpec", "evaluator_base",
    "classification_error_evaluator", "auc_evaluator", "sum_evaluator",
    "column_sum_evaluator", "precision_recall_evaluator", "pnpair_evaluator",
    "chunk_evaluator", "ctc_error_evaluator",
    "value_printer_evaluator", "gradient_printer_evaluator",
    "maxid_printer_evaluator", "maxframe_printer_evaluator",
    "seqtext_printer_evaluator", "classification_error_printer_evaluator",
]


class EvaluatorSpec:
    """Binds an evaluator to layers.  kind='metric' accumulates via the
    impl's (init/update/result); kind='printer' prints the fetched value."""

    def __init__(self, name, impl, input, label=None, weight=None,
                 kind="metric", printer=None, value_mode=False, adapter=None,
                 extra_inputs=None, **update_kw):
        self.name = name
        self.impl = impl
        self.input = input
        self.label = label
        self.weight = weight
        self.kind = kind
        self.printer = printer
        self.value_mode = value_mode   # impl.update takes value= not pred=
        # adapter(pred, label, weight, extra) -> kwargs for impl.update, for
        # impls whose signature differs from pred/label/weight (chunk, ctc)
        self.adapter = adapter
        # {update_kw_name: LayerOutput} resolved by the trainer each batch
        # (e.g. pnpair's query_id)
        self.extra_inputs = dict(extra_inputs or {})
        self.update_kw = update_kw
        self.state = impl.init() if impl is not None else None

    def reset(self):
        if self.impl is not None:
            self.state = self.impl.init()

    def update(self, pred, label=None, weight=None, extra=None):
        if self.kind == "printer":
            self.printer(self.name, pred, label)
            return
        kw = dict(self.update_kw)
        kw.update(extra or {})
        if self.adapter is not None:
            kw.update(self.adapter(pred, label, weight, extra or {}))
            self.state = self.impl.update(self.state, **kw)
        elif self.value_mode:
            self.state = self.impl.update(self.state, value=pred,
                                          weight=weight, **kw)
        else:
            self.state = self.impl.update(self.state, pred=pred, label=label,
                                          weight=weight, **kw)

    def result(self):
        return self.impl.result(self.state) if self.impl is not None else None


def evaluator_base(input, type, label=None, weight=None, name=None, **kw):
    """Generic ctor (reference evaluator_base): type names an implementation
    registered in evaluators.get."""
    impl = ev_impls.get(type, **kw)
    return EvaluatorSpec(name or type, impl, input, label=label, weight=weight)


def classification_error_evaluator(input, label, weight=None, name=None,
                                   **_):
    return EvaluatorSpec(name or "classification_error",
                         ev_impls.ClassificationError(), input, label, weight)


def auc_evaluator(input, label, weight=None, name=None, **_):
    return EvaluatorSpec(name or "auc", ev_impls.Auc(), input, label, weight)


def sum_evaluator(input, weight=None, name=None, **_):
    return EvaluatorSpec(name or "sum", ev_impls.SumEvaluator(), input,
                         weight=weight, value_mode=True)


def column_sum_evaluator(input, weight=None, name=None, **_):
    return EvaluatorSpec(name or "column_sum",
                         ev_impls.ColumnSum(size=input.size), input,
                         weight=weight, value_mode=True)


def precision_recall_evaluator(input, label, positive_label=None,
                               weight=None, name=None, **_):
    return EvaluatorSpec(
        name or "precision_recall",
        ev_impls.PrecisionRecall(num_classes=input.size,
                                 positive_label=positive_label),
        input, label, weight)


def pnpair_evaluator(input, label, query_id, weight=None, name=None, **_):
    """query_id: a data layer of per-sample query ids; fetched from the feed
    every batch and forwarded to PnPair.update."""
    return EvaluatorSpec(name or "pnpair", ev_impls.PnPair(), input, label,
                         weight, extra_inputs={"query_id": query_id})


def _seq_parts(v):
    """(data, lengths) on the host from a SequenceBatch or a plain
    tensor / array."""
    if hasattr(v, "data") and hasattr(v, "lengths"):
        return _host(v.data), _host(v.lengths)
    return _host(v), None


def chunk_evaluator(input, label, chunk_scheme="IOB", num_chunk_types=None,
                    excluded_chunk_types=(), name=None, **_):
    def adapt(pred, label, weight, extra):
        p, plens = _seq_parts(pred)
        l, _ = _seq_parts(label)
        if p.ndim == 3:                     # tag probs -> tag ids
            p = np.argmax(p, -1)
        return {"pred": p.reshape(p.shape[0], -1),
                "label": l.reshape(l.shape[0], -1),
                "lengths": plens}
    return EvaluatorSpec(
        name or "chunk",
        ev_impls.ChunkEvaluator(scheme=chunk_scheme,
                                num_chunk_types=num_chunk_types,
                                excluded_chunk_types=excluded_chunk_types),
        input, label, adapter=adapt)


def ctc_error_evaluator(input, label, blank=0, name=None, **_):
    """input: per-frame class probs/logits [B, T, C]; greedy CTC decode
    (argmax, collapse repeats, drop blanks — reference CTCErrorEvaluator)
    then edit distance against the label sequences."""
    def adapt(pred, label, weight, extra):
        p, plens = _seq_parts(pred)
        frames = np.argmax(p, -1)           # [B, T]
        if plens is None:
            plens = np.full(frames.shape[0], frames.shape[1])
        dec = np.full_like(frames, -1)
        dlen = np.zeros(frames.shape[0], np.int32)
        for i in range(frames.shape[0]):
            prev = -1
            k = 0
            for t in range(int(plens[i])):
                f = int(frames[i, t])
                if f != prev and f != blank:
                    dec[i, k] = f
                    k += 1
                prev = f
            dlen[i] = k
        l, llens = _seq_parts(label)
        l = l.reshape(l.shape[0], -1)
        if llens is None:
            llens = np.full(l.shape[0], l.shape[1])
        return {"decoded": dec, "decoded_lengths": dlen,
                "label": l, "label_lengths": llens}
    return EvaluatorSpec(name or "ctc_error", ev_impls.CTCError(), input,
                         label, adapter=adapt)


# --------------------------------------------------------------- printers

def _print_value(name, pred, label):
    print(f"[{name}] value:\n{_host(pred)}")


def _print_maxid(name, pred, label):
    print(f"[{name}] argmax ids: {np.argmax(_host(pred), -1)}")


def _print_maxframe(name, pred, label):
    arr = _host(pred)
    idx = np.argmax(arr.reshape(arr.shape[0], -1), -1)
    print(f"[{name}] max frame idx: {idx}")


def value_printer_evaluator(input, name=None, **_):
    return EvaluatorSpec(name or "value_printer", None, input,
                         kind="printer", printer=_print_value)


def gradient_printer_evaluator(input, name=None, **_):
    """Prints the layer value (gradients are not materialized per layer
    in the graph IR; the reference printed both)."""
    return EvaluatorSpec(name or "gradient_printer", None, input,
                         kind="printer", printer=_print_value)


def maxid_printer_evaluator(input, name=None, **_):
    return EvaluatorSpec(name or "maxid_printer", None, input,
                         kind="printer", printer=_print_maxid)


def maxframe_printer_evaluator(input, name=None, **_):
    return EvaluatorSpec(name or "maxframe_printer", None, input,
                         kind="printer", printer=_print_maxframe)


def seqtext_printer_evaluator(input, result_file=None, id_input=None,
                              dict_file=None, name=None, **_):
    """Reference seqtext_printer_evaluator: write generated token ids (or
    dict-mapped words) one sequence per line."""
    vocab = None
    if dict_file:
        with open(dict_file) as f:
            vocab = [line.rstrip("\n") for line in f]

    def printer(nm, pred, label):
        arr = _host(pred.data if hasattr(pred, "lengths") else pred)
        lens = _host(pred.lengths) if hasattr(pred, "lengths") else None
        lines = []
        for i, row in enumerate(arr.reshape(arr.shape[0], -1)):
            ids = row[:int(lens[i])] if lens is not None else row
            toks = ([vocab[t] if 0 <= t < len(vocab) else str(t)
                     for t in ids] if vocab else [str(t) for t in ids])
            lines.append(" ".join(toks))
        text = "\n".join(lines)
        if result_file:
            with open(result_file, "a") as f:
                f.write(text + "\n")
        else:
            print(f"[{nm}]\n{text}")

    return EvaluatorSpec(name or "seqtext_printer", None, input,
                         kind="printer", printer=printer)


def classification_error_printer_evaluator(input, label, name=None, **_):
    def printer(nm, pred, lab):
        ids = np.argmax(_host(pred), -1)
        err = (ids != _host(lab).reshape(ids.shape)).astype(np.float32)
        print(f"[{nm}] per-sample error: {err}")
    return EvaluatorSpec(name or "classification_error_printer", None, input,
                         label=label, kind="printer", printer=printer)
