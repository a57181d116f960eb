"""Data exchange of the port: the feature-container helpers and
``ArrayDataset``, the numpy data source that stands in for the object
store's ``Dataset`` until the store is ported."""
