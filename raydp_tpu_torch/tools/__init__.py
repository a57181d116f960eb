"""The repository's trace tools (``tools/trace_smoke.py``,
``tools/trace_analyze.py``) as the port's own scripts, each run as
``python -m raydp_tpu_torch.tools.<name>``."""
