"""WikiQA answer-selection loader (BASELINE.json configs[2]); a copy of the
JAX package's ``data/wikiqa.py``, which is plain Python.

The reference stubs word2vec-binary loading for WikiQA
(do_trec_qa_clean.py:94-114, 272-273) but ships no WikiQA parser; this
completes the path.  WikiQA distributes as TSV
(WikiQA-{train,dev,test}.tsv) with columns:

    QuestionID  Question  DocumentID  DocumentTitle  SentenceID  Sentence  Label

Tokenization mirrors the TREC-QA pipeline's lowercase split (there the
corpus is pre-tokenized with tabs; WikiQA is raw text, so we lowercase and
split on whitespace after stripping punctuation edges), and everything
downstream (vocab, IDF, overlap features, center padding, group ids) reuses
the trec_qa module so both datasets flow through one pipeline.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict

from .trec_qa import (
    compute_dfs,
    encode_split,
    build_vocab,
)

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def _tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def parse_wikiqa_tsv(path_or_text: str):
    """Returns (qids, questions, answers, labels); skips the header row.
    Accepts a file path or the TSV TEXT itself; a missing path raises
    instead of silently parsing the path string as an empty corpus."""
    if os.path.exists(path_or_text):
        with open(path_or_text, encoding="utf-8", errors="replace") as f:
            lines = f.read().splitlines()
    elif "\n" in path_or_text or "\t" in path_or_text:
        lines = path_or_text.splitlines()
    else:
        raise FileNotFoundError(path_or_text)
    qids, questions, answers, labels = [], [], [], []
    for i, line in enumerate(lines):
        parts = line.split("\t")
        if len(parts) < 7:
            continue
        if i == 0 and parts[0].strip().lower() == "questionid":
            continue
        qids.append(parts[0])
        questions.append(_tokenize(parts[1]))
        answers.append(_tokenize(parts[5]))
        labels.append(1 if parts[6].strip() == "1" else 0)
    return qids, questions, answers, labels


def prepare_wikiqa(train_tsv, dev_tsv, test_tsv, w2v: dict, *, q_len=40,
                   a_len=40, stoplist=None):
    """Same artifact shape as prepare_trec_qa: (splits, vocab_info)."""
    tr = parse_wikiqa_tsv(train_tsv)
    dv = parse_wikiqa_tsv(dev_tsv)
    te = parse_wikiqa_tsv(test_tsv)

    all_words_iter = []
    for split in (tr, dv, te):
        for sent in split[1] + split[2]:
            all_words_iter.extend(sent)
    seen = OrderedDict((w, None) for w in all_words_iter)
    vocab, unknown_idx, pad_idx, vocab_size, pretrained = build_vocab(
        seen.keys(), w2v)

    qids_tr, questions_tr, _, _ = tr
    uniq = set()
    unique_questions = []
    for q, qid in zip(questions_tr, qids_tr):
        if qid not in uniq:
            uniq.add(qid)
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
