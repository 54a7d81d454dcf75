"""TREC-QA data preparation: XML -> packed index arrays (a copy of the
JAX package's ``data/trec_qa.py``, which is numpy only).

Reproduces the semantics of the reference QA script's ``make_data``
(do_trec_qa_clean.py:75-320) -- the parsing rules, vocab construction,
IDF/overlap features, and center-padding -- while replacing its HDF5-chunk
output with npz arrays (contiguous host arrays a trainer can slice and
ship, not a chunked-file emulation).

Semantics checklist (all cited):
* XML walk: qid from ``<QApairs id='...'>``; the line after ``<question>``
  is the tab-tokenized lowercased question; a line whose *previous* line is
  ``<positive>``/``<negative>`` is an answer with that label; answers longer
  than 60 tokens are skipped (:116-150)
* vocab = corpus∩GloVe words in *corpus iteration order*, then two extra
  indices: unknown = n, pad = n+1, vocab size n+2 (:278-301)
* IDF over train answers + per-qid-unique train questions:
  df[w] = log(num_docs / doc_freq) (:152-160, 306-313)
* overlap features per pair: [|Q∩A| / (|Qset|+|Aset|),
  idf_overlap / (|Qset|+|Aset|)] with 11.0 for OOV-idf words (:162-182)
* encoding: per-token index (unknown for OOV), truncate to maxlen, then
  CENTER pad with the pad index: pad_before = (maxlen-len)//2 (:184-203)
* group ids: dense re-index of qids via list(set(qids)).index -- order is
  arbitrary-but-fixed; here the deterministic first-appearance order is
  used (:212-213).  Metrics never depend on the id values themselves.
"""

from __future__ import annotations

import math
import os
import re
from collections import OrderedDict, defaultdict

import numpy as np

QID_RE = re.compile(r"<QApairs id='(.*)'>")
LABEL_RE = re.compile(r"^<(positive|negative)>")
MAX_ANSWER_TOKENS = 60  # answers longer than this are skipped (:139-141)


def parse_trec_xml(path_or_text: str):
    """Returns (qids, questions, answers, labels); tokens are lowercased
    tab-split lists, mirroring load_data (do_trec_qa_clean.py:116-150)."""
    if os.path.exists(path_or_text):
        with open(path_or_text, encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    else:
        lines = path_or_text.splitlines(keepends=True)
    qids, questions, answers, labels = [], [], [], []
    prev = ""
    qid = None
    question: list[str] = []
    for raw in lines:
        line = raw.strip()
        m = QID_RE.match(line)
        if m:
            qid = m.group(1)
        if prev and prev.startswith("<question>"):
            question = line.lower().split("\t")
        lm = LABEL_RE.match(prev)
        if lm:
            answer = line.lower().split("\t")
            if len(answer) > MAX_ANSWER_TOKENS:
                # BUG-FOR-BUG with the reference: its `continue` skips
                # the `prev = line` update (do_trec_qa_clean.py:139-147),
                # so the NEXT line (the closing </positive>/</negative>
                # tag) matches the stale prev and lands as a spurious
                # 1-token answer with the same label.  Row counts,
                # vocab, and IDF must match reference-produced
                # artifacts, quirks included.
                continue
            labels.append(1 if lm.group(1) == "positive" else 0)
            answers.append(answer)
            questions.append(question)
            qids.append(qid)
        prev = line
    return qids, questions, answers, labels


def compute_dfs(docs):
    """word -> log(num_docs / doc_freq) (do_trec_qa_clean.py:152-160)."""
    word2df = defaultdict(float)
    for doc in docs:
        for w in set(doc):
            word2df[w] += 1.0
    num_docs = len(docs)
    return {w: math.log(num_docs / v) for w, v in word2df.items()}


def compute_overlap_features(questions, answers, *, word2df=None,
                             stoplist=None):
    """(n, 2) float array (do_trec_qa_clean.py:162-182)."""
    word2df = word2df or {}
    stoplist = set(stoplist or ())
    feats = np.zeros((len(questions), 2), np.float32)
    for i, (q, a) in enumerate(zip(questions, answers)):
        q_set = {w for w in q if w not in stoplist}
        a_set = {w for w in a if w not in stoplist}
        overlap = q_set & a_set
        df_overlap = sum(word2df.get(w, 11.0) for w in overlap)
        # the reference divides unguarded (do_trec_qa_clean.py:177) and
        # would crash on a fully-stoplisted pair; that input never occurs
        # in its data, so guarding to 0 here cannot affect parity
        denom = len(q_set) + len(a_set) or 1
        feats[i] = (len(overlap) / denom, df_overlap / denom)
    return feats


def build_vocab(all_words, w2v: dict):
    """Returns (word->index OrderedDict over corpus∩w2v, unknown_idx,
    pad_idx, vocab_size, pretrained (n, D) array in index order).

    The pretrained array is exactly what the reference writes to
    wiki_dict.txt and the Embed layer reloads into rows [0, n)
    (do_trec_qa_clean.py:283-289; embed_layer.cpp:52-62)."""
    index = OrderedDict()
    rows = []
    for word in all_words:
        if word in w2v and word not in index:
            index[word] = len(index)
            rows.append(np.asarray(w2v[word], np.float32))
    n = len(index)
    pretrained = np.stack(rows) if rows else np.zeros((0, 0), np.float32)
    return index, n, n + 1, n + 2, pretrained


def encode_tokens(tokens, vocab, unknown_idx, pad_idx, maxlen):
    """Center-pad/truncate to maxlen (do_trec_qa_clean.py:184-203)."""
    ids = [vocab.get(t, unknown_idx) for t in tokens]
    slen = len(tokens)
    pad_b = max(0, (maxlen - slen) // 2)
    pad_a = max(0, maxlen - pad_b - slen)
    out = [pad_idx] * pad_b + ids[:maxlen] + [pad_idx] * pad_a
    assert len(out) == maxlen
    return out


def encode_split(qids, questions, answers, labels, vocab, unknown_idx,
                 pad_idx, *, q_len=40, a_len=40, word2df=None, stoplist=None):
    """One split -> dict of arrays {question, answer, label, group,
    overlap_feat} (the HDF5 tops of do_trec_qa_clean.py:236-246)."""
    seen: dict[str, int] = {}
    groups = np.asarray([seen.setdefault(q, len(seen)) for q in qids],
                        np.int32)
    q_arr = np.asarray(
        [encode_tokens(q, vocab, unknown_idx, pad_idx, q_len)
         for q in questions], np.int32)
    a_arr = np.asarray(
        [encode_tokens(a, vocab, unknown_idx, pad_idx, a_len)
         for a in answers], np.int32)
    feats = compute_overlap_features(questions, answers, word2df=word2df,
                                     stoplist=stoplist)
    return {
        "question": q_arr,
        "answer": a_arr,
        "label": np.asarray(labels, np.int32),
        "group": groups,
        "overlap_feat": feats,
    }


def prepare_trec_qa(train_xml, dev_xml, test_xml, w2v: dict, *, q_len=40,
                    a_len=40, stoplist=None):
    """Full data prep: three splits + vocab artifacts.

    Returns (splits, vocab_info) where splits = {'train','dev','test'} dicts
    and vocab_info = {'vocab', 'unknown_idx', 'pad_idx', 'vocab_size',
    'pretrained', 'word2df'}.  Mirrors make_data's vocabulary over ALL
    splits' words (:253-261) and IDF over train answers + unique train
    questions (:306-313)."""
    tr = parse_trec_xml(train_xml)
    dv = parse_trec_xml(dev_xml)
    te = parse_trec_xml(test_xml)

    all_words_iter = []
    for split in (tr, dv, te):
        for sent in split[1] + split[2]:
            all_words_iter.extend(sent)
    # set semantics for membership; first-appearance order for determinism
    seen = OrderedDict((w, None) for w in all_words_iter)
    vocab, unknown_idx, pad_idx, vocab_size, pretrained = build_vocab(
        seen.keys(), w2v)

    qids_tr, questions_tr, _, _ = tr
    uniq_seen = set()
    unique_questions = []
    for q, qid in zip(questions_tr, qids_tr):
        if qid not in uniq_seen:
            uniq_seen.add(qid)
            unique_questions.append(q)
    word2df = compute_dfs(tr[2] + unique_questions)

    splits = {}
    for name, (qids, qs, ans, labels) in (("train", tr), ("dev", dv),
                                          ("test", te)):
        splits[name] = encode_split(qids, qs, ans, labels, vocab, unknown_idx,
                                    pad_idx, q_len=q_len, a_len=a_len,
                                    word2df=word2df, stoplist=stoplist)
    vocab_info = {"vocab": vocab, "unknown_idx": unknown_idx,
                  "pad_idx": pad_idx, "vocab_size": vocab_size,
                  "pretrained": pretrained, "word2df": word2df}
    return splits, vocab_info


def save_dataset(path: str, split: dict):
    np.savez_compressed(path, **split)


def load_dataset(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# synthetic fixtures (the generate_sample_data.py analogue,
# src/caffe/test/test_data/generate_sample_data.py)
# ---------------------------------------------------------------------------

def synthetic_world(vocab_words=22500, n_topics=250, n_common=500, dim=50,
                    seed=0, oov_frac=0.12, topic_strength=0.65):
    """A TREC-QA-sized synthetic 'world': a topic-structured vocabulary and
    GloVe-style embeddings over it, shared across splits.

    Words are partitioned into ``n_topics`` topic pools (plus a common pool
    of function-word stand-ins).  Each word's embedding is a mix of its
    topic centroid and private noise, so *semantic* relatedness lives in
    embedding space -- exactly the structure the bilinear SimCross metric
    (sim_cross_layer.cpp:140-161) is built to exploit -- while *lexical*
    identity carries no extra signal (splits inject literal question tokens
    into positives and negatives at the same rate, see synthetic_split).
    A random ``oov_frac`` of words is withheld from the w2v dict so the
    unknown-index path (do_trec_qa_clean.py:297-301) is exercised at scale.

    Returns a dict consumed by :func:`synthetic_split`.
    """
    rng = np.random.default_rng(seed)
    n_topic_words = vocab_words - n_common
    per_topic = n_topic_words // n_topics
    words, topic_pools = [], []
    common_pool = [f"c{i}" for i in range(n_common)]
    words.extend(common_pool)
    for t in range(n_topics):
        pool = [f"t{t}w{i}" for i in range(per_topic)]
        topic_pools.append(pool)
        words.extend(pool)
    centroids = rng.normal(scale=0.35, size=(n_topics, dim))
    oov = set(rng.choice(len(words), size=int(len(words) * oov_frac),
                         replace=False).tolist())
    w2v = {}
    for i, w in enumerate(words):
        if i in oov:
            continue
        noise = rng.normal(scale=0.35, size=dim)
        if w.startswith("t"):
            t = int(w[1:].split("w")[0])
            vec = topic_strength * centroids[t] \
                + (1.0 - topic_strength) * noise
        else:
            vec = noise
        w2v[w] = vec.astype(np.float32).tolist()
    return {"topic_pools": topic_pools, "common_pool": common_pool,
            "w2v": w2v, "n_topics": n_topics, "rng_seed": seed}


def synthetic_split(world, n_questions, answers_lo, answers_hi, seed, *,
                    pos_frac=0.25, q_tokens=(5, 10), a_tokens=(10, 28),
                    literal_rate=0.10, topic_rate=0.45, all_neg_frac=0.03,
                    weak_pos_frac=0.0, weak_topic_rate=0.2,
                    distractor_frac=0.0, distractor_topic_rate=0.2):
    """One TREC-QA-format XML split over a :func:`synthetic_world`.

    Per question: a topic t, question tokens mostly from pool t; positive
    answers draw ``topic_rate`` of their tokens from pool t, negatives from
    a different pool t'; BOTH get ``literal_rate`` literal question tokens,
    so the overlap features (do_trec_qa_clean.py:162-182) are equally
    distributed across labels and the only learnable signal is the
    embedding-space topic structure.  ``all_neg_frac`` questions have no
    positive answer (the effective-group filter case, map_layer.cpp:50-55).
    Answer counts vary per question like the real corpus (~22/q on test).

    Hardness knobs (default off; the 'hard' rehearsal variant uses them to
    give the task intrinsic Bayes error, so MAP converges to an interior
    asymptote like real data instead of saturating at 1.0):
    ``weak_pos_frac`` of positives draw topic words at only
    ``weak_topic_rate`` (barely-relevant answers), and ``distractor_frac``
    of negatives additionally draw ``distractor_topic_rate`` of their
    tokens from the QUESTION's topic pool (on-topic-but-wrong answers).
    """
    rng = np.random.default_rng(seed)
    pools = world["topic_pools"]
    common = world["common_pool"]
    n_topics = world["n_topics"]

    def draw(pool, k):
        return [pool[i] for i in rng.integers(0, len(pool), size=k)]

    lines = []
    for qi in range(n_questions):
        t = int(rng.integers(0, n_topics))
        nq = int(rng.integers(q_tokens[0], q_tokens[1] + 1))
        n_topic_q = max(2, int(round(nq * 0.75)))
        q_toks = draw(pools[t], n_topic_q) + draw(common, nq - n_topic_q)
        rng.shuffle(q_toks)
        n_ans = int(rng.integers(answers_lo, answers_hi + 1))
        all_neg = rng.random() < all_neg_frac
        n_pos = 0 if all_neg else max(1, int(round(n_ans * pos_frac)))
        order = rng.permutation(n_ans)
        # positives draw topic words from the pool MINUS the question's own
        # tokens: same embedding-space topic (centroid) signal, but literal
        # overlap stays exactly the injected literal_rate for both classes
        q_set = set(q_toks)
        pos_pool = [w for w in pools[t] if w not in q_set]
        lines.append(f"<QApairs id='{seed}.{qi}'>")
        lines.append("<question>")
        lines.append("\t".join(q_toks))
        lines.append("</question>")
        for ai in order:
            pos = bool(ai < n_pos)
            na = int(rng.integers(a_tokens[0], a_tokens[1] + 1))
            n_lit = int(round(na * literal_rate))
            rate = topic_rate
            src = pos_pool if pos else \
                pools[(t + 1 + int(rng.integers(0, n_topics - 1)))
                      % n_topics]
            # short-circuit so disabled knobs consume NO rng draws (the
            # default stream -- and the committed artifacts -- stay exact)
            if weak_pos_frac and pos and rng.random() < weak_pos_frac:
                rate = weak_topic_rate        # barely-relevant positive
            if distractor_frac and not pos \
                    and rng.random() < distractor_frac:
                # on-topic-but-wrong: question-topic words at
                # distractor_topic_rate and NO foreign-topic block --
                # token-for-token the weak-positive recipe, so when the
                # two rates' densities overlap, no ranker can separate
                # these from weak positives (intrinsic Bayes error)
                rate = distractor_topic_rate
                src = pos_pool
            n_top = int(round(na * rate))
            toks = (draw(src, n_top)
                    + [q_toks[i] for i in rng.integers(0, len(q_toks),
                                                       size=n_lit)])
            toks += draw(common, max(0, na - len(toks)))
            rng.shuffle(toks)
            tag = "positive" if pos else "negative"
            lines.append(f"<{tag}>")
            lines.append("\t".join(toks))
            lines.append(f"</{tag}>")
        lines.append("</QApairs>")
    return "\n".join(lines)


def synthetic_corpus(n_questions=12, answers_per_q=6, vocab_words=80, dim=50,
                     seed=0):
    """Generate a TREC-QA-format XML string + a GloVe-style w2v dict with a
    plantable signal: positive answers share content words with their
    question.  Lets the E2E pipeline (parse -> vocab -> train -> eval) run
    hermetically in tests."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_words)]
    w2v = {w: rng.normal(scale=0.3, size=dim).astype(np.float32).tolist()
           for w in words[: int(vocab_words * 0.85)]}  # some OOV words
    lines = []
    for qi in range(n_questions):
        content = rng.choice(vocab_words, size=4, replace=False)
        q_tokens = [words[c] for c in content]
        lines.append(f"<QApairs id='{qi + 1}.{qi}'>")
        lines.append("<question>")
        lines.append("\t".join(q_tokens))
        lines.append("</question>")
        for ai in range(answers_per_q):
            pos = ai < max(1, answers_per_q // 3)
            if pos:
                toks = q_tokens[:2] + [words[int(c)] for c in
                                       rng.choice(vocab_words, size=3)]
            else:
                toks = [words[int(c)] for c in rng.choice(vocab_words, size=5)]
            tag = "positive" if pos else "negative"
            lines.append(f"<{tag}>")
            lines.append("\t".join(toks))
            lines.append(f"</{tag}>")
        lines.append("</QApairs>")
    return "\n".join(lines), w2v
