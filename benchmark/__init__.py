"""The benchmark of ``wfl_asr_tpu_torch`` (see ``run.py``)."""
