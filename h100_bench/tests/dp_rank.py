"""One rank of a small run of the four-card training cell on the CPU over
gloo (``test_dp.py`` starts four): ``python -m h100_bench.tests.dp_rank
RANK OUT FAULT``.  FAULT ``none`` runs the program as it is;
``no_exchange`` leaves out every exchange between the ranks (the
gradient all-reduce and BN's sums), so each rank trains on its own rows."""

import sys

import torch

from h100_bench import run as harness
from h100_bench.tests.cells import small_run


def main(rank: int, out: str, fault: str) -> int:
    torch.set_num_threads(1)
    if fault == "no_exchange":
        import mms_answer_selection_tpu_torch.parallel.collectives as coll
        from mms_answer_selection_tpu_torch.training import trainer

        trainer.reduce_grads = lambda grads, loss, shards: (grads, loss)
        coll.all_reduce_sum = lambda x, group=None: x
    run = small_run("v4.train_recipe_dp4", seconds=2.0)
    return harness.runner(run).rank_main(run, rank, out)


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2], sys.argv[3]))
