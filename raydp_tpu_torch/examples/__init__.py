"""The repository's eight examples (``examples/*.py``) as the port's own
scripts, each run as ``python -m raydp_tpu_torch.examples.<name>``:

- ``nyctaxi``: ETL feature engineering, then ``Estimator``'s
  ``MLPRegressor`` on the card (``examples/nyctaxi_jax.py``);
- ``data_process``: a pure ETL report, on the hosts;
- ``dlrm_criteo``: hashed Criteo-shaped ids and a dp x tp ``DLRM`` fit on
  the card (``dlrm_optimizer``, ``dlrm_sharding_rules``), one rank or
  ``torch.distributed.run``'s ranks;
- ``nyctaxi_torch``: ``TorchEstimator``'s DDP ranks on the card;
- ``nyctaxi_xgboost`` and ``nyctaxi_tf``: ``XGBoostEstimator`` (the native
  GBDT where xgboost is not installed) and ``TFEstimator``, on the hosts;
- ``spmd_job_example``: a gang of four rank actors, on the hosts;
- ``long_context_lm``: a ring-attention ``TransformerLM`` with the
  sequence sharded over the ranks, on the card.

Each keeps its JAX script's environment knobs (``EXAMPLE_ROWS``,
``EXAMPLE_EPOCHS``, ``EXAMPLE_ROUNDS``) and defaults, widths, seeds, query,
estimator settings and printed lines, and has a ``main(argv=None)``. A
script that reaches the card takes ``--device`` (the card by default,
raising when there is none; ``--device cpu`` runs it on the CPU).
"""
