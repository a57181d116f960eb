"""``raydp-tpu-torch-submit``: submit a script with operator overrides,
the port's counterpart of ``raydp_tpu/submit.py``.

The reference's ``bin/raydp-submit`` wraps spark-submit so operators pin
executor resources and configuration from the command line while the
application code stays unchanged. Here the submitted configuration is
published to the environment as JSON under ``RAYDP_TPU_SUBMIT_CONF`` (the
user's knob keeps the JAX package's name), and ``etl.session.init_etl``
reads it through ``submitted_overrides`` as operator overrides: the CLI's
values win over the application's arguments, as spark-submit's ``--conf``
does.

Usage:
    python -m raydp_tpu_torch.submit --num-executors 4 --executor-cores 2 \\
        --executor-memory 2G --conf etl.default.parallelism=16 script.py [args]
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys

SUBMIT_ENV = "RAYDP_TPU_SUBMIT_CONF"


def submitted_overrides() -> dict:
    raw = os.environ.get(SUBMIT_ENV)
    return json.loads(raw) if raw else {}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="raydp-tpu-torch-submit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--num-executors", type=int)
    parser.add_argument("--executor-cores", type=int)
    parser.add_argument("--executor-memory", type=str)
    parser.add_argument(
        "--conf", action="append", default=[], metavar="KEY=VALUE",
        help="extra session config (repeatable)",
    )
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    overrides: dict = {"configs": {}}
    if args.num_executors is not None:
        overrides["num_executors"] = args.num_executors
    if args.executor_cores is not None:
        overrides["executor_cores"] = args.executor_cores
    if args.executor_memory is not None:
        overrides["executor_memory"] = args.executor_memory
    for conf in args.conf:
        if "=" not in conf:
            parser.error(f"--conf expects KEY=VALUE, got {conf!r}")
        key, value = conf.split("=", 1)
        overrides["configs"][key] = value

    os.environ[SUBMIT_ENV] = json.dumps(overrides)
    sys.argv = [args.script] + args.script_args
    runpy.run_path(args.script, run_name="__main__")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
