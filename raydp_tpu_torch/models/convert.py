"""Carry flax weights to PyTorch state_dicts: ``TransformerLM``
(``params_from_flax``), ``MLPRegressor``/``MLPClassifier``
(``mlp_params_from_flax``) and ``DLRM`` (``dlrm_params_from_flax``).

The flax tree is ``Embed_0/embedding``, ``pos_embed``,
``Block_i/{LayerNorm_0, qkv, proj, LayerNorm_1, Dense_0, Dense_1}``
(``CheckpointBlock_i`` when the flax model was built with ``remat``),
``LayerNorm_0`` and ``lm_head``. The MLPs' tree is ``Dense_0`` ...
``Dense_n``. DLRM's is ``Dense_0`` ... for the bottom MLP, then on for the
top MLP (flax numbers unnamed layers across both), ``bottom_proj``,
``embedding_i`` (bare [vocab, D] arrays) and ``head``. A gradient tree has
the same structure and converts the same way. Flax ``Dense`` kernels are [in, out];
``nn.Linear`` weights are [out, in], so every kernel is transposed.

A DLRM whose tables are split over a mesh axis takes its weights through
``table_shard``: the rows of a whole table that the rank at a coordinate
holds (``parallel.sharding.scatter_state`` cuts a whole state dict so;
``gather_full`` is the inverse, on the ranks).

The JAX package's pipeline and experts keep one stage's or expert's
parameters a device as pytrees stacked on a leading dim; a rank of the
port holds its own. ``stacked_slice`` takes rank r's slice of such a tree
as tensors (an expert's ``t @ W`` takes its kernel as it is), and
``stage_blocks_from_flax`` turns a stage of stacked flax ``Block`` trees
(``Block_i`` for the stage's i-th block) into the state_dict of an
``nn.Sequential`` of the port's ``Block``.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCK_DENSE = {"qkv": "qkv", "proj": "proj", "Dense_0": "fc1", "Dense_1": "fc2"}
_BLOCK_NORM = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def params_from_flax(params: dict) -> dict:
    """flax ``TransformerLM`` params (with or without the outer ``"params"``
    key; leaves numpy or anything ``np.asarray`` reads) -> an f32 CPU
    state_dict for ``raydp_tpu_torch.models.transformer.TransformerLM``.
    ``load_state_dict`` casts each tensor to the parameter's dtype."""
    tree = params.get("params", params)
    out = {
        "embed.weight": _t(tree["Embed_0"]["embedding"]),
        "pos_embed": _t(tree["pos_embed"]),
    }
    layer = 0
    prefix = "CheckpointBlock" if "CheckpointBlock_0" in tree else "Block"
    while f"{prefix}_{layer}" in tree:
        block = tree[f"{prefix}_{layer}"]
        for name, ours in _BLOCK_DENSE.items():
            _dense(out, f"blocks.{layer}.{ours}", block[name])
        for name, ours in _BLOCK_NORM.items():
            _norm(out, f"blocks.{layer}.{ours}", block[name])
        layer += 1
    _norm(out, "ln_f", tree["LayerNorm_0"])
    _dense(out, "lm_head", tree["lm_head"])
    return out


def mlp_params_from_flax(params: dict) -> dict:
    """flax ``MLPRegressor``/``MLPClassifier`` params -> an f32 CPU
    state_dict for ``raydp_tpu_torch.models.mlp``: ``Dense_i`` ->
    ``dense.i``."""
    tree = params.get("params", params)
    out = {}
    layer = 0
    while f"Dense_{layer}" in tree:
        _dense(out, f"dense.{layer}", tree[f"Dense_{layer}"])
        layer += 1
    return out


def dlrm_params_from_flax(params: dict) -> dict:
    """flax ``DLRM`` params -> an f32 CPU state_dict for
    ``raydp_tpu_torch.models.dlrm.DLRM``: ``Dense_i`` -> ``dense.i`` (bottom
    then top), ``bottom_proj``, ``embedding_i`` and ``head`` by name."""
    tree = params.get("params", params)
    out = mlp_params_from_flax(tree)
    _dense(out, "bottom_proj", tree["bottom_proj"])
    _dense(out, "head", tree["head"])
    table = 0
    while f"embedding_{table}" in tree:
        out[f"embedding_{table}"] = _t(tree[f"embedding_{table}"])
        table += 1
    return out


def table_shard(table, axis_size: int, axis_index: int) -> np.ndarray:
    """The rows of a whole [V, D] table held by the rank at coordinate
    ``axis_index`` of an axis of ``axis_size`` ranks: ``[axis_index * V/N,
    (axis_index + 1) * V/N)``."""
    table = np.asarray(table)
    if table.shape[0] % axis_size:
        raise ValueError(f"{table.shape[0]} rows do not split over "
                         f"{axis_size} ranks")
    rows = table.shape[0] // axis_size
    return table[axis_index * rows:(axis_index + 1) * rows]


def _slice_tree(tree, index: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, index) for v in tree)
    return np.asarray(tree)[index]


def stacked_slice(tree, index: int):
    """Rank ``index``'s slice of a pytree (dicts, lists and tuples) whose
    leaves carry a leading stage or expert dim: the same structure with
    f32 CPU tensors of ``leaf[index]``."""
    sliced = _slice_tree(tree, index)
    if isinstance(sliced, np.ndarray):
        return _t(sliced)
    import torch.utils._pytree as pytree

    return pytree.tree_map(_t, sliced)


def stage_blocks_from_flax(stacked: dict, index: int) -> dict:
    """Stage ``index`` of stacked flax ``Block`` params (``Block_0`` ...
    each leaf [stages, ...]) -> the f32 CPU state_dict of an
    ``nn.Sequential`` of the port's ``Block``: ``Block_i`` -> ``i.qkv``,
    ``i.proj``, ``i.fc1``, ``i.fc2``, ``i.ln1``, ``i.ln2``."""
    tree = _slice_tree(stacked.get("params", stacked), index)
    out = {}
    i = 0
    while f"Block_{i}" in tree:
        block = tree[f"Block_{i}"]
        for name, ours in _BLOCK_DENSE.items():
            _dense(out, f"{i}.{ours}", block[name])
        for name, ours in _BLOCK_NORM.items():
            _norm(out, f"{i}.{ours}", block[name])
        i += 1
    return out
