"""The SPMD job launcher on the port: the counterpart of the repository's
``examples/spmd_job_example.py``. Ship a function to a gang of four rank
actors and gather the results, on the hosts::

    python -m raydp_tpu_torch.examples.spmd_job_example
"""

from __future__ import annotations

from raydp_tpu_torch.examples._common import owned_runtime, parser


def main(argv=None) -> dict:
    """Run the example; returns the ranks' lines and the sum."""
    parser(__doc__, device=False).parse_args(argv)

    import raydp_tpu_torch

    with owned_runtime():
        job = raydp_tpu_torch.create_spmd_job("demo", world_size=4).start()
        try:
            lines = job.run(
                lambda ctx: f"hello from rank {ctx.rank}/{ctx.world_size}")
            for line in lines:
                print(line)
            # numeric allreduce-style aggregation via gather
            partials = job.run(
                lambda ctx: sum(range(ctx.rank * 100, (ctx.rank + 1) * 100)))
            print("sum over ranks:", sum(partials))
        finally:
            job.stop()
    return {"lines": lines, "sum": sum(partials)}


if __name__ == "__main__":
    main()
