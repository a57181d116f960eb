"""What the examples share: the ``--device`` flag, the environment knobs
and the teardown of the runtime a script started."""

from __future__ import annotations

import argparse
import contextlib
import os


def knob(name: str, default: int) -> int:
    """An ``EXAMPLE_*`` environment knob (rows, epochs, rounds)."""
    return int(os.environ.get(name, default))


def parser(doc: str, device: bool = True) -> argparse.ArgumentParser:
    """The script's parser; ``--device`` where it reaches the card (the
    card by default, raising when there is none; ``cpu`` asks for the
    CPU)."""
    out = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    if device:
        out.add_argument("--device", default=None,
                         help="where the model runs: the card (the default; "
                              "raises when there is none) or cpu")
    return out


@contextlib.contextmanager
def owned_runtime():
    """Stop, on the way out, the ETL sessions and the cluster this script
    started; a cluster that was up before it is left as it was."""
    from raydp_tpu_torch.cluster import api

    started = not api.is_initialized()
    try:
        yield
    finally:
        if started:
            from raydp_tpu_torch.etl import session as etl

            while etl.active_session() is not None:
                etl.stop_etl()
            api.shutdown()
