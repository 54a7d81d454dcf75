"""The one traffic generator: sentences, corpora and query batches drawn
from the seed, shaped by a traffic file's parameters.

Sentence lengths follow the synthetic TREC-QA corpus of the port's data
prep (``data/trec_qa.py``, ``synthetic_split``): questions of
``q_tokens`` = [5, 10] tokens, answers of ``a_tokens`` = [10, 28],
center-padded to ``maxlen`` with the pad index, pad_before = (maxlen -
len) // 2, as the recipe's prep pads (do_trec_qa_clean.py:184-203).  The
vocabulary is ``vocab_size`` = n + 2 ids as the prep builds it: n words,
then the unknown index n and the pad index n + 1.  Word ids follow a
Zipf law of exponent ``zipf_s`` over the n words; ``oov_rate`` of the
tokens are words outside the embedding dictionary, the unknown index.

Every draw is made on ``device`` by a ``torch.Generator`` seeded from
(seed, stream), in a few large calls, so the same seed gives the same
inputs and two streams never share draws.
"""

from __future__ import annotations

import numpy as np
import torch

# stream tags: what each draw is for
CANDIDATES, QUERIES, WEIGHTS, CORPUS, SAMPLE = 1, 2, 3, 4, 5


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` whose state is a fixed function of (seed,
    stream); seeds of any size."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def _zipf_cdf(n: int, s: float, device) -> torch.Tensor:
    p = torch.arange(1, n + 1, device=device, dtype=torch.float64) ** -s
    return torch.cumsum(p / p.sum(), 0)


def sentences(gen: torch.Generator, count: int, lengths, traffic: dict,
              device) -> torch.Tensor:
    """(count, maxlen) int32 token ids: lengths uniform in ``lengths``
    (inclusive), Zipf words, the unknown index at ``oov_rate``, center
    padding with the pad index."""
    vocab, maxlen = int(traffic["vocab_size"]), int(traffic["maxlen"])
    words, unknown, pad = vocab - 2, vocab - 2, vocab - 1
    lo, hi = int(lengths[0]), int(lengths[1])
    n = torch.randint(lo, hi + 1, (count, 1), generator=gen, device=device)
    u = torch.rand((count, maxlen), generator=gen, device=device,
                   dtype=torch.float64)
    ids = torch.searchsorted(_zipf_cdf(words, float(traffic["zipf_s"]),
                                       device), u).clamp_(max=words - 1)
    oov = torch.rand((count, maxlen), generator=gen, device=device) \
        < float(traffic["oov_rate"])
    ids = torch.where(oov, torch.full_like(ids, unknown), ids)
    pos = torch.arange(maxlen, device=device)[None, :]
    before = (maxlen - n) // 2
    real = (pos >= before) & (pos < before + n)
    return torch.where(real, ids, torch.full_like(ids, pad)).to(torch.int32)


def query_batches(seed: int, traffic: dict, device) -> torch.Tensor:
    """(batches, batch, maxlen) question ids, drawn ahead of the window."""
    gen = generator(seed, QUERIES, device)
    nb, b = int(traffic["query_batches"]), int(traffic["batch"])
    return sentences(gen, nb * b, traffic["q_tokens"], traffic,
                     device).view(nb, b, -1)


def candidates(seed: int, traffic: dict, device) -> torch.Tensor:
    """(pool, maxlen) answer ids of the candidate pool."""
    gen = generator(seed, CANDIDATES, device)
    return sentences(gen, int(traffic["pool"]), traffic["a_tokens"],
                     traffic, device)


def _overlap(q: torch.Tensor, a: torch.Tensor, idf: torch.Tensor,
             pad: int) -> torch.Tensor:
    """Two overlap features of each pair, shaped as the prep's
    (do_trec_qa_clean.py:162-182): the answer's tokens that occur in the
    question over (question + answer tokens), and their summed IDF over
    the same count."""
    real_q, real_a = q != pad, a != pad
    hit = ((a[:, :, None] == q[:, None, :]) & real_q[:, None, :]).any(-1) \
        & real_a
    denom = (real_q.sum(1) + real_a.sum(1)).to(torch.float32)
    w = idf[a.long()] * hit
    return torch.stack([hit.sum(1) / denom, w.sum(1) / denom], 1)


def corpus_split(gen: torch.Generator, pairs: int, answers, traffic: dict,
                 idf, device) -> dict:
    """One split of ``pairs`` question-answer pairs: questions of
    ``answers`` = [lo, hi] answers each (the last one cut to fit), a
    quarter of each question's answers positive, at least one; host numpy
    arrays in the prep's dtypes."""
    lo, hi = int(answers[0]), int(answers[1])
    sizes = torch.randint(lo, hi + 1, (pairs // lo + 1,), generator=gen,
                          device=device).cpu()
    ends = torch.cumsum(sizes, 0)
    nq = int(torch.searchsorted(ends, torch.tensor(pairs)).item()) + 1
    sizes = sizes[:nq].clone()
    sizes[-1] -= int(ends[nq - 1]) - pairs
    group = torch.repeat_interleave(torch.arange(nq), sizes).to(device)
    q = sentences(gen, nq, traffic["q_tokens"], traffic, device)[group]
    a = sentences(gen, pairs, traffic["a_tokens"], traffic, device)
    start = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(pairs) - torch.repeat_interleave(start, sizes)
    n_pos = torch.clamp(torch.round(sizes * float(traffic["pos_frac"])),
                        min=1)
    label = (rank < torch.repeat_interleave(n_pos, sizes)).to(torch.int32)
    perm = torch.randperm(pairs, generator=gen, device=device)
    q, a, group = q[perm], a[perm], group[perm]
    label = label.to(device)[perm]
    feat = _overlap(q, a, idf, int(traffic["vocab_size"]) - 1)
    return {"question": q.cpu().numpy(), "answer": a.cpu().numpy(),
            "overlap_feat": feat.cpu().numpy(),
            "label": label.cpu().numpy().astype(np.int32),
            "group": group.cpu().numpy().astype(np.int32)}


def corpus(seed: int, traffic: dict, device) -> dict:
    """{'train', 'dev'} splits of ``train_pairs`` / ``dev_pairs`` pairs.
    IDF is the Zipf law's: log(words / rank)."""
    gen = generator(seed, CORPUS, device)
    words = int(traffic["vocab_size"]) - 2
    idf = torch.log(words / torch.arange(1, words + 3, device=device,
                                         dtype=torch.float32))
    idf[words:] = 11.0      # the prep's IDF for words it has no count of
    return {name: corpus_split(gen, int(traffic[f"{name}_pairs"]),
                               traffic[f"{name}_answers"], traffic, idf,
                               device)
            for name in ("train", "dev")}


def sample(seed: int, population: int, count: int) -> list[int]:
    """``count`` distinct indices of ``population``, drawn from the seed."""
    gen = generator(seed, SAMPLE, "cpu")
    count = min(count, population)
    return sorted(torch.randperm(population, generator=gen)[:count].tolist())
