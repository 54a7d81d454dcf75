"""Token saliency: gradient magnitudes of the loss with respect to the
embeddings (counterpart of ``utils/saliency.py``).

The reference's ``test_networks_single`` (do_trec_qa_clean.py:654-779)
backprops the trained net to the embedding outputs and plots per-token
|gradient| heatmaps as saliency.png.  Here that is one
``torch.autograd.grad`` through the real model (``mms_qa_apply`` with the
embedding activations given), so any architecture change shows in it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mms_qa import MMSQAConfig, mms_qa_apply
from ..ops.embed import embed_lookup


def token_saliency(params, state, batch, cfg: MMSQAConfig):
    """Returns (q_saliency (N, W1), a_saliency (N, W2)) as numpy: per-token
    summed |d loss / d embedding|, the reference's
    np.sum(np.fabs(diff), 1).  ``batch`` needs 'label'; tensors on the
    params' device."""
    q_emb = embed_lookup(params["embed"], batch["question"]).detach() \
        .requires_grad_(True)
    a_emb = embed_lookup(params["embed"], batch["answer"]).detach() \
        .requires_grad_(True)
    out, _ = mms_qa_apply(params, state, batch, cfg, train=False,
                          q_emb=q_emb, a_emb=a_emb)
    gq, ga = torch.autograd.grad(out["loss"], (q_emb, a_emb))
    return (torch.sum(torch.abs(gq), dim=-1).cpu().numpy(),
            torch.sum(torch.abs(ga), dim=-1).cpu().numpy())


def save_saliency_png(path, q_sal, a_sal) -> bool:
    """saliency.png analogue (two stacked gray heatmaps); False, and no
    file, where matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001 - plotting is optional
        return False
    fig, (ax1, ax2) = plt.subplots(2, 1)
    ax1.imshow(np.atleast_2d(q_sal), cmap="gray_r", aspect="auto")
    ax1.set_ylabel("question")
    ax2.imshow(np.atleast_2d(a_sal), cmap="gray_r", aspect="auto")
    ax2.set_ylabel("answer")
    fig.savefig(path)
    plt.close(fig)
    return True
