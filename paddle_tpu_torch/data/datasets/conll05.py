"""CoNLL-05 SRL (``paddle_tpu/data/datasets/conll05.py``, a copy;
reference v2/dataset/conll05.py: word/predicate features + IOB label
sequence).

Real data: PADDLE_TPU_DATA_DIR/conll05/ holding the reference layout —
`test.wsj.words.gz` (one token per line, blank line between sentences) and
`test.wsj.props.gz` (star-bracket proposition columns, one per predicate) —
plus optional wordDict.txt / verbDict.txt / targetDict.txt (one entry per
line; built from the data when absent).  Without the files, a synthetic
fallback keeps air-gapped runs working.

Yields (word_ids, [pred_id] * len, label_ids) per (sentence, predicate)
pair, labels in B-X/I-X/O encoding (2*kind / 2*kind+1 / 2*KINDS).  The
synthetic fallback gives the JAX package's samples element for element:
sentences of 5-39 tokens, 1024 for train and 128 for test."""

import gzip
import os

from paddle_tpu_torch.data.datasets._synth import local_path, rng_for

WORD_DICT = 4000
PRED_DICT = 300
LABEL_KINDS = 19   # span types
NUM_LABELS = 2 * LABEL_KINDS + 1


def _dir():
    return local_path("conll05")


def _open(name):
    p = os.path.join(_dir(), name)
    return gzip.open(p, "rt") if p.endswith(".gz") else open(p)


def _sentences(words_file, props_file):
    """Parse the words/props pair into (tokens, [(pred_lemma, tags)])."""
    with _open(words_file) as wf, _open(props_file) as pf:
        toks, prop_rows = [], []
        for wline, pline in zip(wf, pf):
            wline, pline = wline.strip(), pline.rstrip("\n").strip()
            if not wline:
                if toks:
                    yield toks, prop_rows
                toks, prop_rows = [], []
                continue
            toks.append(wline.split()[0])
            prop_rows.append(pline.split())
        if toks:
            yield toks, prop_rows


def _props_to_iob(prop_rows, col):
    """Star-bracket column -> per-token span labels [(kind|None, is_begin)]."""
    labels, current = [], None
    for row in prop_rows:
        tag = row[col + 1] if col + 1 < len(row) else "*"
        begin = False
        if "(" in tag:
            current = tag[tag.index("(") + 1:].split("*")[0].rstrip(")")
            begin = True
        labels.append((current, begin))
        if ")" in tag:
            current = None
    return labels


_dict_cache = {}


def _load_or_build_dicts():
    # building the dicts scans the whole corpus — cache per data dir
    # (movielens._meta pattern)
    key = _dir()
    if key in _dict_cache:
        return _dict_cache[key]

    def load(fname):
        p = os.path.join(_dir(), fname)
        if os.path.exists(p):
            with open(p) as f:
                return {w.strip(): i for i, w in enumerate(f) if w.strip()}
        return None

    wd, vd, td = (load(f) for f in
                  ("wordDict.txt", "verbDict.txt", "targetDict.txt"))
    if wd is not None and vd is not None and td is not None:
        _dict_cache[key] = (wd, vd, td)
        return wd, vd, td
    # build from the data
    words, verbs, kinds = {}, {}, {}
    for toks, rows in _sentences("test.wsj.words.gz", "test.wsj.props.gz"):
        for t in toks:
            words.setdefault(t, len(words))
        for row in rows:
            if row and row[0] != "-":
                verbs.setdefault(row[0], len(verbs))
        ncols = max((len(r) - 1 for r in rows), default=0)
        for c in range(ncols):
            for kind, _ in _props_to_iob(rows, c):
                if kind is not None:
                    kinds.setdefault(kind, len(kinds))
    targets = {}
    for kind in kinds:
        targets.setdefault(f"B-{kind}", len(targets))
        targets.setdefault(f"I-{kind}", len(targets))
    targets["O"] = len(targets)
    result = ((wd or words), (vd or verbs), (td or targets))
    _dict_cache[key] = result
    return result


def get_dict():
    if os.path.exists(os.path.join(_dir(), "test.wsj.words.gz")):
        return _load_or_build_dicts()
    return ({f"w{i}": i for i in range(WORD_DICT)},
            {f"v{i}": i for i in range(PRED_DICT)},
            {f"l{i}": i for i in range(NUM_LABELS)})


def _real_reader(word_dict, verb_dict, target_dict):
    o_id = target_dict.get("O", len(target_dict) - 1)

    def reader():
        for toks, rows in _sentences("test.wsj.words.gz",
                                     "test.wsj.props.gz"):
            word_ids = [word_dict.get(t, len(word_dict) - 1) for t in toks]
            preds = [i for i, r in enumerate(rows) if r and r[0] != "-"]
            for col, pi in enumerate(preds):
                pred_id = verb_dict.get(rows[pi][0], len(verb_dict) - 1)
                labels = []
                for kind, begin in _props_to_iob(rows, col):
                    if kind is None:
                        labels.append(o_id)
                    else:
                        tag = f"{'B' if begin else 'I'}-{kind}"
                        labels.append(target_dict.get(tag, o_id))
                yield word_ids, [pred_id] * len(toks), labels
    return reader


def _synth_reader(split, n):
    def reader():
        rng = rng_for("conll05", split)
        for _ in range(n):
            length = int(rng.randint(5, 40))
            words = list(rng.randint(0, WORD_DICT, size=length))
            pred = int(rng.randint(0, PRED_DICT))
            labels = []
            t = 0
            while t < length:
                span = min(int(rng.randint(1, 4)), length - t)
                kind = int(rng.randint(0, LABEL_KINDS))
                labels.extend([2 * kind] + [2 * kind + 1] * (span - 1))
                t += span
            yield words, [pred] * length, labels
    return reader


def _reader(split, n):
    if os.path.exists(os.path.join(_dir(), "test.wsj.words.gz")):
        # the reference's own quirk (v2/dataset/conll05.py:202): the CoNLL05
        # train set is not freely distributable, so the TEST set serves for
        # both train() and test()
        return _real_reader(*_load_or_build_dicts())
    return _synth_reader(split, n)


def train():
    return _reader("train", 1024)


def test():
    return _reader("test", 128)
