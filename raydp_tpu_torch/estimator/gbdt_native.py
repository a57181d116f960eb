"""Native distributed histogram GBDT: the port's own copy of
``raydp_tpu/estimator/gbdt_native.py``, the backend ``XGBoostEstimator``
uses when ``xgboost`` is not installed (as on the card's machine).

GBDT is host-side math: it stays numpy on the ranks' and the driver's CPUs
and has no card path, as in the JAX package, where it has no TPU path
(SURVEY.md section 2.4). The same numpy on the same shards gives the same
trees, edges, base score and predictions as the JAX package's copy, bit for
bit. The distributed shape is the reference's xgboost_ray one on the port's
SPMD job runtime:

- each rank holds its shard binned to uint8 (quantile bins, like xgboost's
  'hist' tree method) and caches preds/grad/hess between calls;
- tree growth is LEVEL-WISE: per level the driver ships the partial tree,
  ranks return per-node (grad, hess) histograms, and the driver reduces them
  and picks best splits (the reduction rides the driver instead of Rabit:
  same semantics, simpler transport);
- leaf values are the standard second-order estimates -G/(H+lambda).

Supported objectives: reg:squarederror, binary:logistic (the two the
reference's examples exercise).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_BINS = 64

# rank-process-local state, keyed by job name (functions shipped to a rank
# run in the same worker process for the job's lifetime, so module globals
# persist across job.run calls)
_STATE: Dict[str, Dict[str, Any]] = {}


@dataclasses.dataclass
class Tree:
    feature: np.ndarray  # int32 [nodes]; -1 = leaf
    threshold_bin: np.ndarray  # int32 [nodes]; go left when bin <= threshold
    left: np.ndarray  # int32 [nodes]
    right: np.ndarray  # int32 [nodes]
    value: np.ndarray  # float32 [nodes]; leaf output


def _new_tree() -> Tree:
    return Tree(
        feature=np.array([-1], np.int32),
        threshold_bin=np.array([0], np.int32),
        left=np.array([-1], np.int32),
        right=np.array([-1], np.int32),
        value=np.array([0.0], np.float32),
    )


def _descend(tree: Tree, binned: np.ndarray) -> np.ndarray:
    """Vectorized node assignment of every row under a (partial) tree."""
    n = binned.shape[0]
    node = np.zeros(n, np.int32)
    for _ in range(64):  # depth bound; loop exits when all rows hit leaves
        feat = tree.feature[node]
        active = feat >= 0
        if not active.any():
            break
        rows = np.nonzero(active)[0]
        f = feat[rows]
        go_left = binned[rows, f] <= tree.threshold_bin[node[rows]]
        node[rows] = np.where(
            go_left, tree.left[node[rows]], tree.right[node[rows]]
        )
    return node


def _bin_features(features: np.ndarray, edges: List[np.ndarray]) -> np.ndarray:
    binned = np.empty(features.shape, np.uint8)
    for f in range(features.shape[1]):
        binned[:, f] = np.searchsorted(edges[f], features[:, f], side="left").astype(
            np.uint8
        )
    return binned


def _grad_hess(pred: np.ndarray, y: np.ndarray, objective: str):
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-pred))
        return p - y, np.maximum(p * (1.0 - p), 1e-16)
    # reg:squarederror
    return pred - y, np.ones_like(pred)


def _loss(pred: np.ndarray, y: np.ndarray, objective: str) -> float:
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-pred))
        eps = 1e-12
        return float(-np.mean(y * np.log(p + eps) + (1 - y) * np.log(1 - p + eps)))
    return float(np.mean((pred - y) ** 2))


# ---------------------------------------------------------------------------
# rank-side functions (picklable classes shipped via job.run)
# ---------------------------------------------------------------------------


class InitFn:
    """Load this rank's shard, reply with a quantile sample for binning."""

    def __init__(self, job_key: str, shards, feature_columns, label_column,
                 sample_rows: int = 4096):
        self.job_key = job_key
        self.shards = shards
        self.feature_columns = feature_columns
        self.label_column = label_column
        self.sample_rows = sample_rows

    def __call__(self, ctx):
        features, labels = self.shards[ctx.rank].to_numpy(
            self.feature_columns, self.label_column
        )
        features = np.asarray(features, np.float64)
        labels = np.asarray(labels, np.float64).reshape(-1)
        _STATE[self.job_key] = {"features": features, "labels": labels}
        n = len(features)
        take = min(self.sample_rows, n)
        idx = np.random.default_rng(ctx.rank).choice(n, take, replace=False)
        return {"n": n, "label_sum": float(labels.sum()), "sample": features[idx]}


class BinFn:
    """Bin the local shard with the driver's global quantile edges."""

    def __init__(self, job_key: str, edges: List[np.ndarray], base: float):
        self.job_key = job_key
        self.edges = edges
        self.base = base

    def __call__(self, ctx):
        st = _STATE[self.job_key]
        st["binned"] = _bin_features(st["features"], self.edges)
        st["pred"] = np.full(len(st["features"]), self.base, np.float64)
        return True


class GradFn:
    """Refresh grad/hess from the current predictions (start of a round)."""

    def __init__(self, job_key: str, objective: str):
        self.job_key = job_key
        self.objective = objective

    def __call__(self, ctx):
        st = _STATE[self.job_key]
        st["grad"], st["hess"] = _grad_hess(
            st["pred"], st["labels"], self.objective
        )
        return True


class HistFn:
    """Per-node (grad, hess) histograms of the local shard under the partial
    tree — the piece a Rabit allreduce would sum; here the driver reduces."""

    def __init__(self, job_key: str, tree: Tree, active_nodes: List[int],
                 n_bins: int):
        self.job_key = job_key
        self.tree = tree
        self.active_nodes = active_nodes
        self.n_bins = n_bins

    def __call__(self, ctx):
        st = _STATE[self.job_key]
        binned, g, h = st["binned"], st["grad"], st["hess"]
        assign = _descend(self.tree, binned)
        n_feat = binned.shape[1]
        out = {}
        for node in self.active_nodes:
            mask = assign == node
            if not mask.any():
                out[node] = np.zeros((n_feat, self.n_bins, 2), np.float64)
                continue
            b = binned[mask]
            gg, hh = g[mask], h[mask]
            hist = np.zeros((n_feat, self.n_bins, 2), np.float64)
            for f in range(n_feat):
                hist[f, :, 0] = np.bincount(
                    b[:, f], weights=gg, minlength=self.n_bins
                )[: self.n_bins]
                hist[f, :, 1] = np.bincount(
                    b[:, f], weights=hh, minlength=self.n_bins
                )[: self.n_bins]
            out[node] = hist
        return out


class ApplyFn:
    """Fold the finalized tree into the local predictions; report local loss."""

    def __init__(self, job_key: str, tree: Tree, learning_rate: float,
                 objective: str):
        self.job_key = job_key
        self.tree = tree
        self.learning_rate = learning_rate
        self.objective = objective

    def __call__(self, ctx):
        st = _STATE[self.job_key]
        st["pred"] += self.learning_rate * self.tree.value[
            _descend(self.tree, st["binned"])
        ]
        return {
            "n": len(st["pred"]),
            "loss_sum": _loss(st["pred"], st["labels"], self.objective)
            * len(st["pred"]),
        }


class CleanupFn:
    def __init__(self, job_key: str):
        self.job_key = job_key

    def __call__(self, ctx):
        _STATE.pop(self.job_key, None)
        return True


# ---------------------------------------------------------------------------
# driver-side training loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NativeBooster:
    """The trained model: predictable on raw (unbinned) feature matrices."""

    trees: List[Tree]
    edges: List[np.ndarray]
    base_score: float
    objective: str
    learning_rate: float

    def predict(self, features: np.ndarray, output_margin: bool = False):
        features = np.asarray(features, np.float64)
        binned = _bin_features(features, self.edges)
        margin = np.full(binned.shape[0], self.base_score, np.float64)
        for tree in self.trees:
            margin += self.learning_rate * tree.value[_descend(tree, binned)]
        if self.objective == "binary:logistic" and not output_margin:
            return 1.0 / (1.0 + np.exp(-margin))
        return margin

    def save_raw(self) -> bytes:
        import pickle

        return pickle.dumps(self)

    @staticmethod
    def load_raw(blob: bytes) -> "NativeBooster":
        import pickle

        model = pickle.loads(blob)
        if not isinstance(model, NativeBooster):
            raise TypeError("not a NativeBooster blob")
        return model


def _best_split(hist: np.ndarray, lam: float, min_child_weight: float):
    """(gain, feature, bin) of the best split for one node's histogram, or
    None. Vectorized over features x bins via cumulative sums."""
    G = hist[:, :, 0].sum(axis=1)  # [F] (same total every feature)
    H = hist[:, :, 1].sum(axis=1)
    gl = np.cumsum(hist[:, :, 0], axis=1)  # [F, B] left-of-or-at bin
    hl = np.cumsum(hist[:, :, 1], axis=1)
    gr = G[:, None] - gl
    hr = H[:, None] - hl
    valid = (hl >= min_child_weight) & (hr >= min_child_weight)
    parent = (G[0] ** 2) / (H[0] + lam)
    gain = gl**2 / (hl + lam) + gr**2 / (hr + lam) - parent
    gain = np.where(valid, gain, -np.inf)
    f, b = np.unravel_index(np.argmax(gain), gain.shape)
    if not np.isfinite(gain[f, b]) or gain[f, b] <= 1e-12:
        return None
    return float(gain[f, b]), int(f), int(b)


def train_distributed(
    job,
    shards,
    params: Dict[str, Any],
    num_boost_round: int,
    feature_columns: Sequence[str],
    label_column: str,
) -> Tuple[NativeBooster, List[Dict[str, float]]]:
    """Drive the distributed boosting loop over an ALREADY-STARTED SpmdJob.
    Returns (booster, per-round history)."""
    objective = str(params.get("objective", "reg:squarederror"))
    lr = float(params.get("eta", params.get("learning_rate", 0.3)))
    max_depth = int(params.get("max_depth", 6))
    lam = float(params.get("lambda", params.get("reg_lambda", 1.0)))
    min_child_weight = float(params.get("min_child_weight", 1.0))
    n_bins = min(MAX_BINS, int(params.get("max_bin", MAX_BINS)))

    job_key = f"gbdt-{job.job_name}"
    infos = job.run(InitFn(job_key, shards, list(feature_columns), label_column))
    total = sum(i["n"] for i in infos)
    label_mean = sum(i["label_sum"] for i in infos) / max(total, 1)
    if objective == "binary:logistic":
        p = min(max(label_mean, 1e-6), 1 - 1e-6)
        base = float(np.log(p / (1 - p)))
    else:
        base = float(label_mean)

    sample = np.concatenate([i["sample"] for i in infos], axis=0)
    edges = []
    for f in range(sample.shape[1]):
        qs = np.quantile(sample[:, f], np.linspace(0, 1, n_bins)[1:-1])
        edges.append(np.unique(qs))
    job.run(BinFn(job_key, edges, base))

    trees: List[Tree] = []
    history: List[Dict[str, float]] = []
    try:
        for round_idx in range(num_boost_round):
            job.run(GradFn(job_key, objective))
            tree = _new_tree()
            node_stats: Dict[int, Tuple[float, float]] = {}
            active = [0]
            for _depth in range(max_depth):
                if not active:
                    break
                hists = job.run(HistFn(job_key, tree, active, n_bins))
                reduced = {
                    node: sum(h[node] for h in hists) for node in active
                }
                next_active = []
                for node in active:
                    hist = reduced[node]
                    node_stats[node] = (
                        float(hist[0, :, 0].sum()),
                        float(hist[0, :, 1].sum()),
                    )
                    split = _best_split(hist, lam, min_child_weight)
                    if split is None:
                        continue
                    _gain, f, b = split
                    left_id = len(tree.feature)
                    right_id = left_id + 1
                    tree.feature[node] = f
                    tree.threshold_bin[node] = b
                    tree.left[node] = left_id
                    tree.right[node] = right_id
                    tree.feature = np.append(tree.feature, [-1, -1]).astype(np.int32)
                    tree.threshold_bin = np.append(
                        tree.threshold_bin, [0, 0]
                    ).astype(np.int32)
                    tree.left = np.append(tree.left, [-1, -1]).astype(np.int32)
                    tree.right = np.append(tree.right, [-1, -1]).astype(np.int32)
                    tree.value = np.append(tree.value, [0.0, 0.0]).astype(np.float32)
                    gl = float(hist[f, : b + 1, 0].sum())
                    hl = float(hist[f, : b + 1, 1].sum())
                    g, h = node_stats[node]
                    node_stats[left_id] = (gl, hl)
                    node_stats[right_id] = (g - gl, h - hl)
                    next_active += [left_id, right_id]
                active = next_active
            # leaf values: -G/(H+lambda) for every remaining leaf
            for node, (g, h) in node_stats.items():
                if tree.feature[node] < 0:
                    tree.value[node] = -g / (h + lam)
            applied = job.run(ApplyFn(job_key, tree, lr, objective))
            loss = sum(a["loss_sum"] for a in applied) / max(
                sum(a["n"] for a in applied), 1
            )
            trees.append(tree)
            history.append({"round": round_idx, "train_loss": loss})
    finally:
        try:
            job.run(CleanupFn(job_key))
        except Exception:  # raydp-lint: disable=swallowed-exceptions (distributed cleanup is best-effort; workers GC on exit)
            pass
    booster = NativeBooster(trees, edges, base, objective, lr)
    return booster, history
