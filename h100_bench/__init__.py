"""The H100 benchmark of ``mms_answer_selection_tpu_torch`` (``run.py``)."""
