"""MLDataset — legacy-compat sharded dataset facade.

Parity: the reference's ``RayMLDataset`` (dataset.py:344-581): an explicitly
sharded dataset created from the ETL engine or parquet files, with
shard→rank assignment and a torch adapter. New code should use
``raydp_tpu_torch.exchange.Dataset`` directly; this facade keeps the reference's
from_spark / from_parquet / get_shard / to_torch surface for migrating users.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from raydp_tpu_torch.exchange.dataset import Dataset, dataframe_to_dataset


class MLDataset:
    def __init__(self, shards: List[Dataset]):
        self._shards = shards

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def get_shard(self, shard_index: int) -> Dataset:
        return self._shards[shard_index]

    def count(self) -> int:
        return sum(s.count() for s in self._shards)

    @staticmethod
    def from_etl(
        df,
        num_shards: int,
        shuffle: bool = False,
        shuffle_seed: Optional[int] = None,
        _use_owner: bool = False,
    ) -> "MLDataset":
        """Reference RayMLDataset.from_spark (dataset.py:408-449)."""
        ds = dataframe_to_dataset(df, _use_owner=_use_owner)
        if shuffle:
            ds = ds.random_shuffle(seed=shuffle_seed or 0)
        return MLDataset(ds.split(num_shards, equal=True))

    # migration alias
    from_spark = from_etl

    @staticmethod
    def from_parquet(
        paths,
        num_shards: int,
        shuffle: bool = False,
        shuffle_seed: Optional[int] = None,
    ) -> "MLDataset":
        """Reference RayMLDataset.from_parquet (dataset.py:451-496)."""
        from raydp_tpu_torch.exchange.dataset import dataset_from_parquet

        ds = dataset_from_parquet(paths)
        if shuffle:
            ds = ds.random_shuffle(seed=shuffle_seed or 0)
        return MLDataset(ds.split(num_shards, equal=True))

    def to_torch(
        self,
        shard_index: int,
        feature_columns: Sequence[str],
        label_column: Optional[str] = None,
        batch_size: int = 32,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ):
        """Reference RayMLDataset.to_torch (dataset.py:498-581)."""
        return self._shards[shard_index].to_torch(
            feature_columns, label_column, batch_size, shuffle, seed
        )
