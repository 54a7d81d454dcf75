"""The JAX package's example scripts (``examples/*.py``) as PyTorch twins.

Each module keeps its script's file name, flags and defaults and runs as

    python -m mms_answer_selection_tpu_torch.examples.<name> [flags]

Each has ``main(argv=None)``, which returns the result the script prints
(its summary dict), so tests and ``chip_smoke.py`` call it in process.
Entry points run on the card; the scripts' CPU flags (``--cpu`` in the
recipe, ``--interpret`` in ``serve_load``) choose ``device="cpu"`` and the
plain PyTorch versions.  Without a card and without such a flag a twin
raises, as ``device.resolve_device`` does.  TPU-only arguments
(``enable_compilation_cache``, ``interpret=``) are dropped;
``scan_chunks=`` is kept where a script passes it (the port's engine takes
it: a graph replay, or eager launches).

* ``recipe_scale_rehearsal``: the V4 recipe on the recipe-scale synthetic
  corpus, with ``trec_eval`` parity and docs/runs-style artifacts;
* ``trec_qa_mms``: prep, train, ``trec_eval`` and retrieval through the
  Python API (a hermetic smoke mode without arguments);
* ``retrieval_1m``: brute-force int8 retrieval over 1,048,576 candidates,
  and IVF / the coarse shortlist;
* ``serve_load``: ``QAServer`` under concurrent HTTP clients, unbatched
  and micro-batched;
* ``int8_error_analysis``: int8 against bf16 scores at 2,048, 262,144 and
  1,048,576 candidates (writes ``docs/runs_torch/int8_error_analysis``);
* ``pair_image_metric``: image-pair metric learning;
* ``pycaffe_port``: a pycaffe tutorial script whose only change is the
  import line (needs h5py, which the H100 host lacks).

``generic_mlp.md`` lists the ``examples/generic_mlp`` commands for the
port's CLI.
"""

from __future__ import annotations

import subprocess


def card_description() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or None where it does
    not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None
