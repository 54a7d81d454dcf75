"""The port's IR metrics, trec_eval copy and TREC-QA data prep against the
JAX package's, on the same seeded numpy inputs.

Tolerances: the tensor metrics compute in float32 as the ``*_jax`` forms
do, with sums in another order, so they agree to 1e-6 absolute (a metric
lies in [0, 1]) with the ``*_jax`` forms and to 1e-5 with the float64
numpy forms.  The numpy copies (host metrics, trec_eval, data prep) must
give identical results.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import metrics as JM
from mms_answer_selection_tpu.data import trec_qa as JD
from mms_answer_selection_tpu_torch import metrics as TM
from mms_answer_selection_tpu_torch.data import trec_qa as TD

# the packages re-export the function ``trec_eval`` under the module's name
JTE = importlib.import_module("mms_answer_selection_tpu.metrics.trec_eval")
TTE = importlib.import_module(
    "mms_answer_selection_tpu_torch.metrics.trec_eval")


def _split(n_groups, seed, *, tie_levels=None, degenerate=True):
    """Groups of 1..12 answers with ties (scores drawn from a few levels)
    and, with ``degenerate``, all-positive, all-negative and singleton
    groups mixed in.  Group ids are shuffled so groups interleave."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 13, n_groups)
    groups = np.repeat(np.arange(n_groups), sizes)
    labels = (rng.random(len(groups)) < 0.3).astype(np.int32)
    if degenerate:
        for g in range(0, n_groups, 7):
            labels[groups == g] = 1                  # all positive
        for g in range(3, n_groups, 7):
            labels[groups == g] = 0                  # all negative
    if tie_levels:
        scores = rng.integers(0, tie_levels, len(groups)) / tie_levels
    else:
        scores = rng.random(len(groups))
    perm = rng.permutation(len(groups))
    return (scores[perm].astype(np.float32), labels[perm],
            groups[perm].astype(np.int32))


# (n_groups, ties): below and above the 2048-row switch to the sorted forms
CASES = {"small": (40, None), "ties": (60, 5), "heavy_ties": (30, 2),
         "big": (400, None), "big_ties": (420, 7)}
PAIRS = [("mean_average_precision", True), ("mean_reciprocal_rank", True),
         ("auc", False)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("metric,grouped", PAIRS)
@pytest.mark.parametrize("sorted_form", [False, True])
def test_tensor_metrics_match_jax_and_numpy(case, metric, grouped,
                                            sorted_form):
    n_groups, ties = CASES[case]
    s, l, g = _split(n_groups, seed=n_groups, tie_levels=ties)
    if case.startswith("big"):
        assert len(s) > 2048
    suffix = "_sorted" if sorted_form else ""
    t_fn = getattr(TM, f"{metric}_torch{suffix}")
    j_fn = getattr(JM, f"{metric}_jax{suffix}")
    targs = (torch.from_numpy(s), torch.from_numpy(l)) + \
        ((torch.from_numpy(g),) if grouped else ())
    jargs = (jnp.asarray(s), jnp.asarray(l)) + \
        ((jnp.asarray(g),) if grouped else ())
    got = t_fn(*targs)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(j_fn(*jargs)), atol=1e-6)
    np_fn = getattr(TM, metric)
    want = np_fn(s, l, g) if grouped else np_fn(s, l)
    np.testing.assert_allclose(float(got), want, atol=1e-5)
    assert np_fn is not getattr(JM, metric)
    assert want == (getattr(JM, metric)(s, l, g) if grouped
                    else getattr(JM, metric)(s, l))


def test_tie_rule_is_insertion_order():
    # equal scores: the earlier sample ranks first, so a positive placed
    # after an equal-scored negative has rank 2
    s = torch.tensor([0.5, 0.5, 0.5, 0.1])
    g = torch.zeros(4, dtype=torch.int32)
    for fn in (TM.mean_reciprocal_rank_torch,
               TM.mean_reciprocal_rank_torch_sorted):
        assert float(fn(s, torch.tensor([0, 1, 0, 0]), g)) == 0.5
        assert float(fn(s, torch.tensor([1, 0, 0, 0]), g)) == 1.0


@pytest.mark.parametrize("labels", [[1, 1, 1], [0, 0, 0]])
def test_degenerate_splits_score_zero(labels):
    s = torch.tensor([0.3, 0.2, 0.1])
    lab, g = torch.tensor(labels), torch.zeros(3, dtype=torch.int32)
    for name in ("mean_average_precision", "mean_reciprocal_rank"):
        for suffix in ("", "_sorted"):
            assert float(getattr(TM, f"{name}_torch{suffix}")(s, lab, g)) == 0
    assert float(TM.auc_torch(s, lab)) == float(TM.auc_torch_sorted(s, lab))
    assert float(TM.auc_torch(s, lab)) == 0.0


def test_auc_valid_mask_and_rank_accuracy():
    s, l, _ = _split(30, seed=9, tie_levels=4)
    valid = np.random.default_rng(1).random(len(s)) < 0.7
    got = TM.auc_torch(torch.from_numpy(s), torch.from_numpy(l),
                       valid=torch.from_numpy(valid))
    want = JM.auc_jax(jnp.asarray(s), jnp.asarray(l),
                      valid=jnp.asarray(valid))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    a, b = s[:, None], s[::-1].copy()[:, None]
    lab = np.where(l == 1, 1.0, -1.0).astype(np.float32)
    np.testing.assert_allclose(
        float(TM.rank_accuracy_torch(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(lab))),
        float(JM.rank_accuracy_jax(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(lab))), atol=1e-6)


def test_trec_eval_copy_matches(tmp_path):
    s, l, g = _split(50, seed=3)
    out = {}
    for name, mod in (("jax", JTE), ("torch", TTE)):
        truth, result = tmp_path / f"truth_{name}", tmp_path / f"res_{name}"
        mod.write_trec_files(truth, result, s, l, g)
        out[name] = (truth.read_text(), result.read_text(),
                     mod.trec_eval(truth, result),
                     mod.trec_eval(scores=s, labels=l, groups=g))
    assert out["jax"] == out["torch"]
    assert TTE.format_trec_table(out["torch"][2]) == \
        JTE.format_trec_table(out["jax"][2])
    # tie-free: trec_eval's MAP and MRR are the in-process metrics
    ev = out["torch"][2]
    np.testing.assert_allclose(ev["map"], TM.mean_average_precision(s, l, g),
                               rtol=1e-12)
    np.testing.assert_allclose(ev["recip_rank"],
                               TM.mean_reciprocal_rank(s, l, g), rtol=1e-12)


def _assert_same_splits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def test_prepare_trec_qa_matches():
    xml, w2v = TD.synthetic_corpus(n_questions=9, answers_per_q=5, seed=4)
    jxml, jw2v = JD.synthetic_corpus(n_questions=9, answers_per_q=5, seed=4)
    assert (xml, w2v) == (jxml, jw2v)
    t_splits, t_info = TD.prepare_trec_qa(xml, xml, xml, w2v, q_len=12,
                                          a_len=10)
    j_splits, j_info = JD.prepare_trec_qa(xml, xml, xml, w2v, q_len=12,
                                          a_len=10)
    for name in ("train", "dev", "test"):
        _assert_same_splits(t_splits[name], j_splits[name])
    for k in ("vocab", "unknown_idx", "pad_idx", "vocab_size", "word2df"):
        assert t_info[k] == j_info[k]
    np.testing.assert_array_equal(t_info["pretrained"], j_info["pretrained"])


def test_synthetic_recipe_world_matches():
    kw = dict(vocab_words=600, n_topics=12, n_common=40, dim=8, seed=22)
    tw, jw = TD.synthetic_world(**kw), JD.synthetic_world(**kw)
    assert tw == jw
    hard = dict(weak_pos_frac=0.35, distractor_frac=0.3)
    assert TD.synthetic_split(tw, 6, 3, 9, 101, **hard) == \
        JD.synthetic_split(jw, 6, 3, 9, 101, **hard)


def test_dataset_round_trip(tmp_path):
    xml, w2v = TD.synthetic_corpus(n_questions=4, answers_per_q=3, seed=6)
    splits, _ = TD.prepare_trec_qa(xml, xml, xml, w2v)
    TD.save_dataset(str(tmp_path / "train.npz"), splits["train"])
    _assert_same_splits(TD.load_dataset(str(tmp_path / "train.npz")),
                        splits["train"])
