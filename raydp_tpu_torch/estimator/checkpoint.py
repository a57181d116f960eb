"""The estimator's checkpoints: the port's copy of the checkpoint half of
``raydp_tpu/estimator/jax_estimator.py``, in a format of its own.

A checkpoint is one ``torch.save`` of ``{"params": model.state_dict(),
"opt_state": optimizer.state_dict()}`` into ``<dir>/<name>/state.pt``,
where ``<name>`` is ``epoch_N`` (epoch N complete) or ``epoch_N_step_K``
(K steps of epoch N done), the JAX package's names. The file is written
into a temporary sibling directory (``.tmp-<name>-<pid>``), which is
renamed to ``<name>`` only once the file is written and synced, so a bare
``epoch_N`` or ``epoch_N_step_K`` directory is a committed checkpoint, as
orbax's rename makes it in the JAX package. ``latest_checkpoint`` orders
them as the JAX package does: ``epoch_N`` after every ``epoch_N_step_K``.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional, Tuple

import torch

STATE_FILE = "state.pt"
_NAME = re.compile(r"epoch_(\d+)(?:_step_(\d+))?")


def sort_key(found: Tuple[int, Optional[int]]):
    """Order of ``(epoch, step_or_None)``: an epoch's own checkpoint after
    its step checkpoints."""
    return found[0], float("inf") if found[1] is None else found[1]


def latest_checkpoint(checkpoint_dir: Optional[str]):
    """Newest committed checkpoint as ``(epoch, step_or_None)``, or None."""
    if not checkpoint_dir:
        return None
    root = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(root):
        return None
    found = []
    for name in os.listdir(root):
        m = _NAME.fullmatch(name)
        if m and os.path.isdir(os.path.join(root, name)):
            step = int(m.group(2)) if m.group(2) is not None else None
            found.append((int(m.group(1)), step))
    return max(found, key=sort_key) if found else None


def latest_checkpoint_epoch(checkpoint_dir: Optional[str]) -> Optional[int]:
    """Highest epoch with a complete (end-of-epoch) checkpoint on disk."""
    if not checkpoint_dir:
        return None
    root = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(root):
        return None
    epochs = [
        int(m.group(1))
        for name in os.listdir(root)
        for m in [re.fullmatch(r"epoch_(\d+)", name)]
        if m and os.path.isdir(os.path.join(root, name))
    ]
    return max(epochs) if epochs else None


def checkpoint_path(checkpoint_dir: str, epoch: int,
                    step: Optional[int] = None) -> str:
    name = f"epoch_{epoch}" if step is None else f"epoch_{epoch}_step_{step}"
    return os.path.join(os.path.abspath(checkpoint_dir), name)


def save_checkpoint(checkpoint_dir: str, epoch: int, step: Optional[int],
                    model: torch.nn.Module, optimizer: Any) -> int:
    """Write the training state; returns the bytes written. ``step`` is the
    number of completed steps within ``epoch``, None when the epoch is
    complete. An existing checkpoint of the same name is replaced."""
    path = checkpoint_path(checkpoint_dir, epoch, step)
    tmp = os.path.join(os.path.dirname(path),
                       f".tmp-{os.path.basename(path)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    state = {"params": model.state_dict(), "opt_state": optimizer.state_dict()}
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())  # on disk before the rename commits it
        nbytes = f.tell()
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    return nbytes


def load_state(checkpoint_dir: str, epoch: int, step: Optional[int] = None,
               map_location=None) -> dict:
    """The ``{"params", "opt_state"}`` dict of a committed checkpoint."""
    path = os.path.join(checkpoint_path(checkpoint_dir, epoch, step), STATE_FILE)
    return torch.load(path, map_location=map_location, weights_only=True)


def gc_checkpoints(checkpoint_dir: str, epoch: int,
                   keep_checkpoints: Optional[int] = None) -> None:
    """Epoch ``epoch`` is complete: its step checkpoints go, and with
    ``keep_checkpoints`` every epoch checkpoint older than the newest N."""
    root = os.path.abspath(checkpoint_dir)
    try:
        names = os.listdir(root)
    except OSError:
        return
    keep_from = epoch - keep_checkpoints + 1 if keep_checkpoints else None
    for name in names:
        if re.fullmatch(rf"epoch_{epoch}_step_\d+", name):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        elif keep_from is not None:
            m = re.fullmatch(r"epoch_(\d+)", name)
            if m and int(m.group(1)) < keep_from:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
