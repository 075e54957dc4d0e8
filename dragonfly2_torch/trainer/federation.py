"""Federated training round (counterpart of the reference's
``trainer/federation.py``): per-host record shards → per-shard fits →
example-weighted FedAvg merge → one global model.

The trainer's storage keys dataset files by uploading scheduler host
(upstream trainer/storage/storage.go:141-148); each host's shard is a
cluster's view of the swarm. A merged model generalizes across clusters
without ever pooling their raw records — the cross-datacenter shape,
where clusters are separate jobs and only parameters cross between them
(``parallel.fedavg.fedavg_trees``). The fits and the merge run on the
round's device. CSV shards decode through the native decoder
(``schema/native.py``), with the numpy route when it is unavailable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models.mlp import MLP
from dragonfly2_torch.parallel.fedavg import fedavg_trees
from dragonfly2_torch.schema import native, wire
from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import PairExamples, extract_pair_features
from dragonfly2_torch.trainer.train import FitConfig, evaluate_mlp, train_mlp
from dragonfly2_torch.utils import dflog

logger = dflog.get("trainer.federation")


@dataclass
class FederatedResult:
    params: object  # the merged MLP, on the round's device
    metrics: dict[str, float]
    per_host: dict[str, dict] = field(default_factory=dict)
    total_examples: int = 0


def _host_pairs(storage, host_id: str) -> PairExamples:
    # a host that uploaded the binary columnar stream carries its pairs
    # pre-extracted (schema/wire.py); CSV shards decode via the native
    # parser with the numpy path as fallback — identical tensors either
    # way. A host holding BOTH forms (scheduler switched payload formats
    # mid-history) contributes the union, not just the newer era.
    cpath = storage.download_path(host_id)
    pairs = None
    if cpath.exists() and cpath.stat().st_size:
        # bounded at the committed round boundary, same as the binary read
        # below: an in-flight upload's tail may be truncated by a failed
        # stream mid-read
        csv_boundary = storage.download_round_boundary(host_id)
        pairs = native.decode_pairs_file(cpath, end=csv_boundary)
        if pairs is None:
            recs = [
                r
                for chunk in storage.iter_download_chunks(host_id, max_bytes=csv_boundary)
                for r in chunk
            ]
            pairs = extract_pair_features(records_to_columns(recs))
    bpath = storage.download_blocks_path(host_id)
    if bpath.exists() and bpath.stat().st_size:
        # bytes past the round boundary belong to an in-flight upload
        bin_pairs = wire.read_train_pairs(
            bpath, end=storage.download_round_boundary(host_id, binary=True)
        )
        if pairs is None or pairs.features.shape[0] == 0:
            return bin_pairs
        return PairExamples(
            features=np.concatenate([pairs.features, bin_pairs.features]),
            labels=np.concatenate([pairs.labels, bin_pairs.labels]),
            download_index=np.concatenate(
                [pairs.download_index, bin_pairs.download_index + pairs.num_downloads]
            ),
            num_downloads=pairs.num_downloads + bin_pairs.num_downloads,
        )
    if pairs is None:
        pairs = extract_pair_features(records_to_columns(storage.list_download(host_id)))
    return pairs


def federated_fit_mlp(
    storage,
    host_ids: list[str],
    config: FitConfig | None = None,
    mesh=None,
    eval_fraction: float = 0.1,
    device="cuda",
) -> FederatedResult:
    """One federated round over the given hosts' download shards.

    Per shard: an independent MLP fit (one config, so one init — FedAvg of
    one round from a common init). Merge: example-weighted parameter
    average. Evaluation: the merged model scored on a held-out slice
    drawn from EVERY shard, so the metric reflects cross-cluster
    generalization, not any single cluster's distribution. With ``mesh``
    each shard's fit is data parallel over its ``dp`` axis."""
    cfg = config or FitConfig()
    dev = resolve_device(device)
    models, weights = [], []
    eval_x, eval_y = [], []
    per_host: dict[str, dict] = {}
    for host_id in host_ids:
        pairs = _host_pairs(storage, host_id)
        n = pairs.features.shape[0]
        if n == 0:
            per_host[host_id] = {"examples": 0, "skipped": True}
            continue
        n_eval = max(1, int(n * eval_fraction)) if n > 1 else 0
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(n)
        ev, tr = perm[:n_eval], perm[n_eval:]
        if len(tr) == 0:
            per_host[host_id] = {"examples": n, "skipped": True}
            continue
        result = train_mlp(pairs.features[tr], pairs.labels[tr], config=cfg, device=dev, mesh=mesh)
        models.append(result.params.state_dict())
        weights.append(float(len(tr)))
        if n_eval:
            eval_x.append(pairs.features[ev])
            eval_y.append(pairs.labels[ev])
        per_host[host_id] = {"examples": int(len(tr)), "metrics": result.metrics}
    if not models:
        raise ValueError("no host shard produced trainable examples")

    # the merged tree into a module of the fits' widths (layer i's w is [in, out])
    widths = [w.shape for k, w in models[0].items() if k.endswith(".w")]
    merged = MLP([widths[0][0], *(out for _, out in widths)]).to(dev)
    merged.load_state_dict(fedavg_trees(models, weights))
    metrics: dict[str, float] = {}
    if eval_x:
        metrics = evaluate_mlp(merged, np.concatenate(eval_x), np.concatenate(eval_y))
    logger.info(
        "federated round: %d shards, %d examples, merged mse=%s",
        len(models),
        int(sum(weights)),
        metrics.get("mse"),
    )
    return FederatedResult(
        params=merged, metrics=metrics, per_host=per_host, total_examples=int(sum(weights))
    )
