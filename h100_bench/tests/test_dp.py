"""The four-card training cell's path, rehearsed on the CPU: four gloo
ranks through ``runners/train.py``'s ``rank_main``; sound, it is correct
against the one-process reference at the global batch, and with the
exchange between the ranks left out it is not."""

import json
import os
import socket
import subprocess
import sys

import pytest

from h100_bench import run as harness


def ranks(tmp_path, fault):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="4", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "h100_bench.tests.dp_rank", str(r),
         str(tmp_path / f"rank{r}.json"), fault],
        cwd=harness.ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, errs[0][-3000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]


def correct(checks):
    return all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_four_ranks(tmp_path, fault):
    recs = ranks(tmp_path, fault)
    rec = recs[0]
    assert rec["modules"] == [] and rec["attempted"] > 0
    assert rec["work"]["global_batch"] == 4 * rec["work"]["local_batch"]
    assert correct(rec["checks"]) == (fault == "none"), rec["checks"]
    # every rank stopped at the same step
    assert len({r["attempted"] for r in recs}) == 1
