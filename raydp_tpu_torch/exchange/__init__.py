"""Data exchange of the port: the object store's ``Dataset`` (ETL
DataFrames to training data, with ownership semantics), ``MLDataset``,
``ArrayDataset`` (numpy columns in blocks), and the feature-container
helpers. Submodules are imported where they are used: ``features`` and
``torch_io`` import neither pyarrow nor pandas."""
