"""Training orchestration (counterpart of the reference's
``trainer/training.py``; upstream trainer/training/training.go left it a
TODO stub).

``Training.train(ip, hostname)`` loads the uploading scheduler's dataset
from storage, fits the MLP (download records), GraphSAGE (probe graph)
and, with ``gru=True`` (the default), the GRU (per-parent piece-cost
sequences) concurrently, uploads each model with its evaluation metrics
to the manager (``CreateModel``) and clears the consumed dataset. A
failed fit never poisons serving: models upload as inactive and the
manager's activation step gates rollout; a failed GRU leg never gates
the round's ``ok``.

With ``checkpoint_dir`` set, each (model, host) fit snapshots every
epoch under ``<checkpoint_dir>/<model>-<host_id>`` and a restarted round
resumes it. ``federated_round`` fits every uploading host's shard on its
own, merges the fits by example-weighted FedAvg and uploads one global
MLP (``trainer/federation.py``).

Every fit takes the round's ``mesh``: an explicit one, or with
``auto_mesh`` a data-parallel mesh over every rank of the process group
when it has more than one (``parallel.mesh.auto_dp_mesh``; one process a
device, each rank running the same round). CSV payloads decode through
the native C++ decoder (``schema/native.py``), with the reference's numpy
fallback when it is unavailable.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Protocol

import numpy as np
import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.schema import native, wire
from dragonfly2_torch.schema.columnar import concat_columns, records_to_columns
from dragonfly2_torch.schema.features import (
    PieceSequences,
    build_probe_graph,
    extract_pair_features,
    extract_piece_sequences,
)
from dragonfly2_torch.trainer import metrics as M
from dragonfly2_torch.trainer.storage import TrainerStorage
from dragonfly2_torch.trainer.train import (
    FitConfig,
    GNNFitConfig,
    train_gnn,
    train_gru,
    train_mlp,
)
from dragonfly2_torch.utils import dflog, flight, tracing
from dragonfly2_torch.utils.idgen import (
    gnn_model_id_v1,
    gru_model_id_v1,
    host_id_v2,
    mlp_model_id_v1,
)

logger = dflog.get("trainer")

# round milestones in the flight ring: one event per fit leg (with its
# outcome) and one per training round
EV_FIT = flight.event_type("trainer.fit")
EV_ROUND = flight.event_type("trainer.round")


class BelowMinRecords(ValueError):
    """The dataset holds too few records / no trainable pairs to fit —
    the condition the mixed-era fall-through may treat as 'drop the
    sub-minimum tail'. Any other error (corrupt data, decode failure)
    propagates."""


class ManagerClient(Protocol):
    """The slice of the manager API the trainer needs (CreateModel)."""

    def create_model(
        self,
        model_id: str,
        model_type: str,  # "mlp" | "gnn" | "gru"
        ip: str,
        hostname: str,
        params: Any,  # a port module or a parameter tree (serialized by the client)
        evaluation: dict[str, float],
    ) -> None: ...


@dataclass
class TrainingConfig:
    mlp: FitConfig = field(default_factory=FitConfig)
    gnn: GNNFitConfig = field(default_factory=GNNFitConfig)
    gnn_max_degree: int = 16
    min_download_records: int = 1
    min_topology_records: int = 1
    clear_after_train: bool = True
    # incremental rounds: keep dataset files, commit consumed byte offsets
    # after each successful fit and decode only newly appended uploads
    # next round (implies clear_after_train=False)
    incremental: bool = False
    # streaming ingestion (trainer.ingest): decode/train overlapped in
    # bounded memory once the binary dataset file crosses the threshold;
    # below it, the batch path fits with the full FitConfig schedule
    streaming: bool = True
    streaming_threshold_bytes: int = 64 * 1024 * 1024
    streaming_passes: int = 2
    # decode producer pool; 0 = sized off host cores (ingest.default_workers)
    streaming_workers: int = 0
    # optimizer steps folded into one superbatch
    streaming_steps_per_call: int = 1
    # wall bound for one streamed fit; None = unbounded
    streaming_time_budget_s: "float | None" = None
    # third model family: the GRU next-piece-cost predictor over
    # per-parent piece-cost sequences, on by default as in the reference;
    # gru_error never gates .ok, so a host with too few sequences just
    # skips the leg
    gru: bool = True
    gru_min_sequences: int = 8
    # memory bound for the GRU leg: the newest sequences kept per fit
    gru_max_sequences: int = 1_000_000
    gru_config: FitConfig = field(
        default_factory=lambda: FitConfig(hidden_dims=(32,), batch_size=128, epochs=10)
    )
    # the reference's data-parallel mesh over every rank of the process
    # group when it holds more than one (single-process rounds: None)
    auto_mesh: bool = True
    # torch.profiler trace per round ("" = off): <profile_dir>/<host_id>.json
    profile_dir: str = ""
    # elastic restart: per-(model, host) fit snapshots under this
    # directory, resumed after a crash and cleared on success ("" = off)
    checkpoint_dir: str = ""


@dataclass
class TrainingOutcome:
    mlp_metrics: dict[str, float] | None = None
    gnn_metrics: dict[str, float] | None = None
    gru_metrics: dict[str, float] | None = None
    mlp_error: str | None = None
    gnn_error: str | None = None
    gru_error: str | None = None  # GRU is optional; never gates .ok

    @property
    def ok(self) -> bool:
        return self.mlp_error is None and self.gnn_error is None


class Training:
    def __init__(
        self,
        storage: TrainerStorage,
        manager_client: ManagerClient | None = None,
        config: TrainingConfig | None = None,
        mesh=None,
        device="cuda",
    ):
        self.storage = storage
        self.manager_client = manager_client
        self.config = config or TrainingConfig()
        self.device = resolve_device(device)
        if mesh is None and self.config.auto_mesh:
            mesh = self._auto_mesh()
        self.mesh = mesh

    @staticmethod
    def _auto_mesh():
        """A dp mesh over every rank of the process group, or None in a
        single process — a mesh-construction failure degrades to the
        single-device fit, never fails training."""
        try:
            from dragonfly2_torch.parallel.mesh import auto_dp_mesh

            return auto_dp_mesh()
        except Exception:
            logger.warning("auto dp mesh unavailable; fitting single-device", exc_info=True)
            return None

    def train(self, ip: str, hostname: str) -> TrainingOutcome:
        """Fit MLP + GNN (+ GRU) for one uploading scheduler host,
        concurrently (upstream training.go errgroup; in turn over a mesh of
        several ranks)."""
        host_id = host_id_v2(ip, hostname)
        outcome = TrainingOutcome()
        # the caller's span: fit spans in the pool threads parent under
        # it explicitly (contextvars don't cross executor threads)
        parent_span = tracing.current_span()
        # which payload form the MLP leg consumed: the post-fit clear
        # drops exactly that form
        mlp_info: dict = {}
        # over a mesh of several ranks the legs run one after another: their
        # collectives must come in one order on every rank
        legs_at_once = 3 if self.mesh is None or self.mesh.mesh.numel() == 1 else 1
        with self._maybe_profile(host_id), concurrent.futures.ThreadPoolExecutor(
            max_workers=legs_at_once
        ) as pool:
            f_mlp = pool.submit(
                self._timed_fit, "mlp", parent_span, self._train_mlp,
                host_id, ip, hostname, mlp_info,
            )
            f_gnn = pool.submit(
                self._timed_fit, "gnn", parent_span, self._train_gnn,
                host_id, ip, hostname,
            )
            f_gru = (
                pool.submit(
                    self._timed_fit, "gru", parent_span, self._train_gru,
                    host_id, ip, hostname,
                )
                if self.config.gru
                else None
            )
            try:
                outcome.mlp_metrics = f_mlp.result()
            except Exception as e:
                logger.exception("trainMLP failed for %s", host_id)
                outcome.mlp_error = str(e)
            try:
                outcome.gnn_metrics = f_gnn.result()
            except Exception as e:
                logger.exception("trainGNN failed for %s", host_id)
                outcome.gnn_error = str(e)
            if f_gru is not None:
                try:
                    outcome.gru_metrics = f_gru.result()
                except Exception as e:
                    logger.exception("trainGRU failed for %s", host_id)
                    outcome.gru_error = str(e)

        EV_ROUND(
            host_id=host_id,
            ok=outcome.ok,
            mlp_error=outcome.mlp_error or "",
            gnn_error=outcome.gnn_error or "",
            gru_error=outcome.gru_error or "",
        )
        if self.config.clear_after_train and not self.config.incremental:
            # retrain from scratch each round and drop consumed uploads;
            # only the payload form the MLP leg trained on is dropped
            if outcome.mlp_error is None:
                self.storage.clear_download(host_id, binary=mlp_info.get("binary"))
            if outcome.gnn_error is None:
                self.storage.clear_network_topology(host_id)
        return outcome

    def _timed_fit(self, model: str, parent_span, fn, *args):
        span = tracing.get("trainer").start_span("fit", parent=parent_span, model=model)
        t0 = time.perf_counter()
        with tracing.use_span(span):
            try:
                result = fn(*args)
            except Exception as e:
                wall = time.perf_counter() - t0
                M.FIT_DURATION.labels(model).observe(wall)
                EV_FIT(model=model, outcome="failure", error=str(e), wall_s=round(wall, 3))
                span.end("error")
                M.FIT_TOTAL.labels(model, "failure").inc()
                raise
        wall = time.perf_counter() - t0
        M.FIT_DURATION.labels(model).observe(wall)
        EV_FIT(model=model, outcome="success", wall_s=round(wall, 3))
        span.end("ok")
        M.FIT_TOTAL.labels(model, "success").inc()
        M.LAST_FIT_TIMESTAMP.labels(model).set(time.time())
        return result

    @contextlib.contextmanager
    def _maybe_profile(self, host_id: str):
        """A ``torch.profiler`` trace (CPU and, on the card, CUDA
        activity) of the whole round when ``profile_dir`` is set, written
        as ``<profile_dir>/<host_id>.json``. One session records every
        thread (both legs and the ingest stages): the profiler is
        process-wide, and two sessions at once (one per leg, as the
        reference's per-fit traces would be) crash it."""
        if not self.config.profile_dir:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        all_threads = torch.profiler._ExperimentalConfig(profile_all_threads=True)
        with torch.profiler.profile(activities=activities, experimental_config=all_threads) as prof:
            yield
        os.makedirs(self.config.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.config.profile_dir, f"{host_id}.json"))

    # -- trainMLP (upstream training.go:92-98) ----------------------------
    def _train_mlp(
        self, host_id: str, ip: str, hostname: str, info: dict | None = None
    ) -> dict[str, float]:
        # payload selection: binary columnar stream or CSV. When BOTH
        # eras hold pending data (the scheduler switched formats), the
        # older era — CSV — drains first; the consumed form is reported
        # back via ``info`` so train() clears only it
        has_csv = self._pending_bytes(host_id, binary=False) > 0
        has_bin = self._pending_bytes(host_id, binary=True) > 0
        if has_csv and has_bin:
            try:
                return self._train_mlp_from(host_id, ip, hostname, binary=False, info=info)
            except BelowMinRecords as e:
                # the CSV-era leftover alone can't train: fall through to
                # the binary era, dropping the sub-minimum tail with
                # this round's clear (info["binary"]=None → both forms)
                logger.warning(
                    "csv-era leftover for %s untrainable (%s);"
                    " training the binary era and dropping the tail",
                    host_id,
                    e,
                )
                if info is not None:
                    info["binary"] = None
                return self._train_mlp_from(host_id, ip, hostname, binary=True, info=None)
        return self._train_mlp_from(host_id, ip, hostname, binary=has_bin, info=info)

    def _train_mlp_from(
        self,
        host_id: str,
        ip: str,
        hostname: str,
        binary: bool,
        info: dict | None = None,
    ) -> dict[str, float]:
        if info is not None:
            info["binary"] = binary
        path = (
            self.storage.download_blocks_path(host_id)
            if binary
            else self.storage.download_path(host_id)
        )
        offset = (
            self.storage.download_offset(host_id, binary=binary)
            if self.config.incremental
            else 0
        )
        # the boundary is marked by the Train service at stream EOF, so
        # the committed offset never lands mid-record (mid-block)
        boundary = self.storage.download_round_boundary(host_id, binary=binary)
        if self._use_streaming(path, offset, binary):
            return self._train_mlp_streaming(
                host_id, ip, hostname, path, offset, boundary, binary
            )
        if binary:
            pairs = wire.read_train_pairs(path, offset=offset, end=boundary)
        else:
            # bounded at the round boundary like the binary path; the
            # numpy route when the native decoder is unavailable
            pairs = native.decode_pairs_file(path, offset=offset, end=boundary)
            if pairs is None:
                recs = [
                    r
                    for chunk in self.storage.iter_download_chunks(host_id, max_bytes=boundary)
                    for r in chunk
                ]
                pairs = extract_pair_features(records_to_columns(recs))
        if pairs.num_downloads < self.config.min_download_records:
            raise BelowMinRecords(
                f"{pairs.num_downloads} download records for host {host_id}"
                f" < min {self.config.min_download_records}"
            )
        if pairs.features.shape[0] == 0:
            raise BelowMinRecords("no trainable (download, parent) pairs")
        result = train_mlp(
            pairs.features,
            pairs.labels,
            config=self._fit_config(self.config.mlp, "mlp", host_id),
            device=self.device,
            mesh=self.mesh,
        )
        if self.manager_client is not None:
            self.manager_client.create_model(
                model_id=mlp_model_id_v1(ip, hostname),
                model_type="mlp",
                ip=ip,
                hostname=hostname,
                params=result.params,
                evaluation=result.metrics,
            )
        if self.config.incremental:
            # commit only after a fully successful round (incl. upload)
            self.storage.commit_download_offset(host_id, boundary, binary=binary)
        return result.metrics

    def _fit_config(self, cfg, model: str, host_id: str):
        """Stamp the per-(model, host) checkpoint dir onto a fit config
        when elastic restart is enabled — the fit loop then snapshots
        every epoch and resumes from the newest snapshot after a crash
        (trainer/checkpoint.py; cleared on successful completion)."""
        if not self.config.checkpoint_dir:
            return cfg
        return replace(
            cfg,
            checkpoint_dir=os.path.join(self.config.checkpoint_dir, f"{model}-{host_id}"),
        )

    def _pending_bytes(self, host_id: str, binary: bool) -> int:
        path = (
            self.storage.download_blocks_path(host_id)
            if binary
            else self.storage.download_path(host_id)
        )
        offset = (
            self.storage.download_offset(host_id, binary=binary)
            if self.config.incremental
            else 0
        )
        try:
            return os.path.getsize(path) - offset
        except OSError:
            return 0

    def _use_streaming(self, path, offset: int, binary: bool) -> bool:
        # the binary stream needs no native library; CSV streaming rides
        # the fused C++ parser
        if not self.config.streaming:
            return False
        if not binary and not native.available():
            return False
        try:
            pending = os.path.getsize(path) - offset
        except OSError:
            return False
        return pending >= self.config.streaming_threshold_bytes

    def _train_mlp_streaming(
        self,
        host_id: str,
        ip: str,
        hostname: str,
        path,
        offset: int,
        boundary: int,
        binary: bool = False,
    ) -> dict[str, float]:
        """Large-dataset path: bounded-memory overlapped decode + train
        (``trainer.ingest.stream_train_mlp``). Holdout mse/mae stands in
        for ``train_mlp``'s eval split; the model and optimizer family
        are the same."""
        from dragonfly2_torch.trainer.ingest import stream_train_mlp

        cfg = self.config.mlp
        if self.config.min_download_records > 1:
            # cheap pre-gate: a bounded decode stops as soon as min records
            # are seen (binary: from block headers alone)
            if binary:
                rows = wire.count_records(
                    path, offset=offset, max_records=self.config.min_download_records
                )
            else:
                rows = 0
                for _, _, rows in native.stream_pairs_file(
                    path, offset=offset, max_records=self.config.min_download_records
                ):
                    pass
            if rows < self.config.min_download_records:
                raise BelowMinRecords(
                    f"{rows} download records for host {host_id}"
                    f" < min {self.config.min_download_records}"
                )
        eval_every = max(2, round(1.0 / cfg.eval_fraction)) if cfg.eval_fraction > 0 else 0
        mlp, stats = stream_train_mlp(
            path,
            passes=self.config.streaming_passes,
            batch_size=max(cfg.batch_size, 1),
            hidden_dims=cfg.hidden_dims,
            learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay,
            offset=offset,
            # bytes past the round boundary belong to an in-flight upload
            end=boundary,
            workers=self.config.streaming_workers,
            eval_every=eval_every,
            mesh=self.mesh,
            steps_per_call=self.config.streaming_steps_per_call,
            time_budget_s=self.config.streaming_time_budget_s,
            device=self.device,
            init=cfg.init,
        )
        # rows counted once per pass — gate on a single pass's worth
        rows = stats.download_records // max(self.config.streaming_passes, 1)
        if rows < self.config.min_download_records and not stats.truncated:
            raise BelowMinRecords(
                f"{rows} download records for host {host_id}"
                f" < min {self.config.min_download_records}"
            )
        if stats.pairs == 0:
            raise BelowMinRecords("no trainable (download, parent) pairs")
        logger.info(
            "streamed fit for %s: %d records, %d pairs, %d steps, %.0f rec/s",
            host_id,
            rows,
            stats.pairs,
            stats.steps,
            stats.records_per_s,
        )
        if self.manager_client is not None:
            self.manager_client.create_model(
                model_id=mlp_model_id_v1(ip, hostname),
                model_type="mlp",
                ip=ip,
                hostname=hostname,
                params=mlp,
                evaluation=stats.metrics,
            )
        if self.config.incremental:
            self.storage.commit_download_offset(host_id, boundary, binary=binary)
        return stats.metrics

    # -- trainGNN (upstream training.go:82-88) ----------------------------
    def _train_gnn(self, host_id: str, ip: str, hostname: str) -> dict[str, float]:
        # the probe graph is cumulative state (EWMA RTT edges), so the GNN
        # always rebuilds from the whole history
        bpath = self.storage.network_topology_blocks_path(host_id)
        cpath = self.storage.network_topology_path(host_id)
        has_bin = bpath.exists() and bpath.stat().st_size > 0
        has_csv = cpath.exists() and cpath.stat().st_size > 0
        graph = None
        if has_bin:
            batches = []
            if has_csv:
                # format-switch history: CSV rows first — they predate the
                # binary era, and edge RTT is last-write-wins in the build
                batches.append(records_to_columns(self.storage.list_network_topology(host_id)))
            # read bounded by the round boundary so a concurrent upload's
            # tail is never decoded
            batches.append(
                wire.read_columns(
                    bpath,
                    kind=wire.KIND_TOPOLOGY,
                    end=self.storage.network_topology_round_boundary(host_id, binary=True),
                )
            )
            graph = build_probe_graph(concat_columns(batches), max_degree=self.config.gnn_max_degree)
        else:
            graph = native.build_probe_graph_file(cpath, max_degree=self.config.gnn_max_degree)
        if graph is None:
            recs = self.storage.list_network_topology(host_id)
            graph = build_probe_graph(records_to_columns(recs), max_degree=self.config.gnn_max_degree)
        if graph.num_records < self.config.min_topology_records:
            raise ValueError(
                f"{graph.num_records} network topology records for host {host_id}"
                f" < min {self.config.min_topology_records}"
            )
        result = train_gnn(
            graph,
            config=self._fit_config(self.config.gnn, "gnn", host_id),
            device=self.device,
            mesh=self.mesh,
        )
        if self.manager_client is not None:
            self.manager_client.create_model(
                model_id=gnn_model_id_v1(ip, hostname),
                model_type="gnn",
                ip=ip,
                hostname=hostname,
                params=result.params,
                evaluation=result.metrics,
            )
        return result.metrics

    # -- trainGRU (piece time-series; the reference's addition) -----------
    def _train_gru(self, host_id: str, ip: str, hostname: str) -> dict[str, float]:
        # sequence extraction is row-local, so the dataset is read in
        # bounded chunks, both sources up to the committed round boundary
        # (a concurrent Train stream may be appending past it): CSV first
        # (it is older; re-extracted chunk-wise), then the binary blocks,
        # which carry the sequences pre-extracted. The count is capped at
        # the NEWEST gru_max_sequences: records append in time order, so
        # trimming from the front keeps the fit on recent link behavior.
        parts: list[PieceSequences] = []
        total = 0
        cap = self.config.gru_max_sequences
        seq_iters = []
        cpath = self.storage.download_path(host_id)
        if cpath.exists() and cpath.stat().st_size:
            boundary = self.storage.download_round_boundary(host_id)
            seq_iters.append(
                extract_piece_sequences(records_to_columns(chunk))
                for chunk in self.storage.iter_download_chunks(host_id, max_bytes=boundary)
            )
        bpath = self.storage.download_blocks_path(host_id)
        if bpath.exists() and bpath.stat().st_size:
            seq_iters.append(
                wire.stream_gru_sequences(
                    bpath, end=self.storage.download_round_boundary(host_id, binary=True)
                )
            )
        for s in itertools.chain(*seq_iters):
            if s.sequences.shape[0]:
                parts.append(s)
                total += s.sequences.shape[0]
            while parts and total - parts[0].sequences.shape[0] >= cap:
                total -= parts[0].sequences.shape[0]
                parts.pop(0)
        if parts:
            seqs = PieceSequences(
                sequences=np.concatenate([p.sequences for p in parts])[-cap:],
                labels=np.concatenate([p.labels for p in parts])[-cap:],
                lengths=np.concatenate([p.lengths for p in parts])[-cap:],
            )
        else:
            seqs = extract_piece_sequences({})
        n = seqs.sequences.shape[0]
        if n < self.config.gru_min_sequences:
            raise ValueError(
                f"{n} piece sequences for host {host_id}"
                f" < min {self.config.gru_min_sequences}"
            )
        result = train_gru(
            seqs.sequences,
            seqs.labels,
            lengths=seqs.lengths,
            mesh=self.mesh,
            config=self._fit_config(self.config.gru_config, "gru", host_id),
            device=self.device,
        )
        if self.manager_client is not None:
            self.manager_client.create_model(
                model_id=gru_model_id_v1(ip, hostname),
                model_type="gru",
                ip=ip,
                hostname=hostname,
                params=result.params,
                evaluation=result.metrics,
            )
        return result.metrics

    # -- federated round over every uploading host's shard ----------------
    def federated_round(self, config: FitConfig | None = None) -> "dict[str, float]":
        """Fit every host shard independently, FedAvg-merge, upload ONE
        global model (trainer/federation.py). Returns the merged model's
        cross-shard holdout metrics."""
        from dragonfly2_torch.trainer.federation import federated_fit_mlp
        from dragonfly2_torch.utils.idgen import federated_model_id_v1

        host_ids = self.storage.host_ids()
        if not host_ids:
            raise ValueError("no host shards in trainer storage")
        result = federated_fit_mlp(
            self.storage, host_ids, config=config or self.config.mlp, mesh=self.mesh,
            device=self.device,
        )
        if self.manager_client is not None:
            self.manager_client.create_model(
                model_id=federated_model_id_v1(),
                model_type="mlp",
                ip="",
                hostname="federated",
                params=result.params,
                evaluation=result.metrics,
            )
        return result.metrics
