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
