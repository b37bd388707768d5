"""NLTK movie_reviews sentiment set (reference v2/dataset/sentiment.py:1).

Reference call shapes preserved: `train()` / `test()` return ITERATORS of
(word_id_list, 0/1 label) — unlike the other datasets' reader creators,
sentiment.train() in the reference yields directly (sentiment.py:104-117) —
plus `get_word_dict()` -> [(word, id), ...] frequency-sorted, and the
NUM_TRAINING_INSTANCES=1600 / NUM_TOTAL_INSTANCES=2000 split constants.

Real data: the NLTK corpus layout `corpora/movie_reviews/{neg,pos}/*.txt`
under PADDLE_TPU_DATA_DIR (no nltk import needed — the corpus is plain
text files).  Without it, a deterministic synthetic corpus with the same
schema keeps air-gapped runs working.  A copy of
``paddle_tpu/data/datasets/sentiment.py``: the same samples element for
element.
"""

import os

from paddle_tpu_torch.data.datasets._synth import local_path, rng_for, tokenize

__all__ = ["train", "test", "get_word_dict"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

_SYNTH_VOCAB = 512
_SYNTH_LEN = 40


def _corpus_dir():
    return local_path("corpora", "movie_reviews")


def _category_files(category):
    d = os.path.join(_corpus_dir(), category)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".txt"))


def _words(path):
    with open(path, encoding="utf-8", errors="ignore") as f:
        return tokenize(f.read())


def _have_real():
    return bool(_category_files("neg") and _category_files("pos"))


def _synth_corpus():
    """Deterministic two-distribution corpus: negative reviews skew to low
    token ids, positive to high — learnable, like the real set."""
    rng = rng_for("sentiment", "all")
    docs = {"neg": [], "pos": []}
    for cat in ("neg", "pos"):
        lo, hi = (0, _SYNTH_VOCAB // 2) if cat == "neg" \
            else (_SYNTH_VOCAB // 2, _SYNTH_VOCAB)
        for _ in range(NUM_TOTAL_INSTANCES // 2):
            n = int(rng.randint(10, _SYNTH_LEN))
            main = rng.randint(lo, hi, (n,))
            noise = rng.randint(0, _SYNTH_VOCAB, (max(1, n // 4),))
            docs[cat].append([f"w{i}" for i in
                              list(main) + list(noise)])
    return docs


_docs_cache = {}


def _all_docs():
    """{category: [word list per doc]} from real corpus or synthetic —
    memoized per corpus dir, so get_word_dict() + train() + test() read and
    tokenize the 2000 documents once, not three times."""
    key = _corpus_dir() if _have_real() else "<synthetic>"
    if key not in _docs_cache:
        if key == "<synthetic>":
            _docs_cache[key] = _synth_corpus()
        else:
            _docs_cache[key] = {
                cat: [_words(p) for p in _category_files(cat)]
                for cat in ("neg", "pos")}
    return _docs_cache[key]


def _word_dict_for(docs):
    freq = {}
    for cat in ("neg", "pos"):
        for words in docs[cat]:
            for w in words:
                freq[w] = freq.get(w, 0) + 1
    ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(w, i) for i, (w, _) in enumerate(ordered)]


def get_word_dict():
    """Frequency-sorted [(word, id), ...] over the whole corpus (reference
    sentiment.py:51-70)."""
    return _word_dict_for(_all_docs())


def _interleave(neg, pos):
    """neg/pos cross-read for balanced batches (reference sort_files());
    unlike the reference's zip, an uneven corpus keeps its tail instead of
    silently dropping the longer category's extra documents."""
    out = []
    for i in range(max(len(neg), len(pos))):
        if i < len(neg):
            out.append((neg[i], 0))
        if i < len(pos):
            out.append((pos[i], 1))
    return out


def load_sentiment_data():
    """[(word_id_list, label), ...] with neg/pos interleaved for balanced
    cross-reading (reference sort_files(), sentiment.py:73-100).  The
    corpus is read ONCE: the word dict derives from the same docs."""
    docs = _all_docs()
    ids = dict(_word_dict_for(docs))
    return [([ids[w] for w in words], label)
            for words, label in _interleave(docs["neg"], docs["pos"])]


def _reader(data):
    for words, label in data:
        yield words, label


def train():
    """Iterator over the first 1600 samples (reference semantics: returns
    the generator itself, not a creator)."""
    return _reader(load_sentiment_data()[:NUM_TRAINING_INSTANCES])


def test():
    """Iterator over the remaining samples."""
    return _reader(load_sentiment_data()[NUM_TRAINING_INSTANCES:])


def fetch():
    """The reference downloads the NLTK corpus here; this build downloads
    nothing: place the corpus at
    $PADDLE_TPU_DATA_DIR/corpora/movie_reviews/ instead."""
    return _corpus_dir()
