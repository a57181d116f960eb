"""A pure ETL pipeline on the port: the counterpart of the repository's
``examples/data_process.py``. Load, feature engineering, groupby
aggregation, join and a sorted report on the distributed DataFrame
engine, with no training stage; it runs on the hosts only::

    python -m raydp_tpu_torch.examples.data_process

``EXAMPLE_ROWS`` (100,000) sizes the run.
"""

from __future__ import annotations

from raydp_tpu_torch.examples._common import knob, owned_runtime, parser
from raydp_tpu_torch.examples.nyctaxi import synthetic_taxi


def trips_query(df, F):
    """The trips: hour, day of week, passengers and a positive f64 fare."""
    return (
        df.with_column("hour", F.hour("pickup_ts"))
        .with_column("dow", F.dayofweek("pickup_ts"))
        .with_column("fare", F.col("fare_amount").cast("float64"))
        .select("hour", "dow", "passenger_count", "fare")
        .filter(F.col("fare") > 0)
    )


def busiest_report(trips):
    """Hourly stats joined against day-of-week volume, the 10 busiest
    (hour, day) cells first, as pandas."""
    by_hour = trips.groupby("hour").agg(
        trips=("count", "*"), avg_fare=("mean", "fare")
    )
    by_dow = trips.groupby("dow").agg(dow_trips=("count", "*"))
    return (
        trips.groupby("hour", "dow")
        .agg(n=("count", "*"), fare_sum=("sum", "fare"))
        .join(by_hour, on="hour")
        .join(by_dow, on="dow")
        .sort("n", ascending=False)
        .limit(10)
        .to_pandas()
    )


def main(argv=None) -> dict:
    """Run the example; returns the report and the trip count."""
    parser(__doc__, device=False).parse_args(argv)

    import raydp_tpu_torch
    from raydp_tpu_torch.etl import functions as F

    with owned_runtime():
        session = raydp_tpu_torch.init_etl(
            "data-process", num_executors=2, executor_cores=2,
            executor_memory="1G"
        )
        rows = knob("EXAMPLE_ROWS", 100_000)
        trips = trips_query(
            session.from_pandas(synthetic_taxi(rows), num_partitions=8), F)
        report = busiest_report(trips)
        print(report.to_string(index=False))
        count = trips.count()
        print("total trips:", count)
        raydp_tpu_torch.stop_etl()
    return {"report": report, "count": count}


if __name__ == "__main__":
    main()
