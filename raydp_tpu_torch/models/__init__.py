"""Models of the port and their flax weight converters (``convert``):
``TransformerLM`` (decode serving, slice 1; training, slice 2), and
``DLRM`` with ``MLPRegressor`` and ``MLPClassifier`` (DLRM training
through the estimator, slice 3)."""
