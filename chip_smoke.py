#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dragonfly2_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device and build: the card's name and power limit, then the five
   CUDA sources (both flash forwards and the three flash backwards) built with
   ``nvcc`` at once (each timed), with
   ``ptxas``'s registers, spills and added wgmma fences per
   instantiation and, where
   ``cuobjdump`` sits beside ``nvcc``, the count of HGMMA (wgmma)
   instructions in the SASS of each tensor-core library (0 fails);
2. the tf32x3 kernels' pre-passes (the forward's and the backward's)
   against their plain splits, bit for bit (and timed alone at the
   encoder's shape); each flash kernel against the
   plain PyTorch version at every checked shape, with max|err| of O and
   LSE and the share of each limit used; at the
   encoder's shape (float32 → tf32x3, bfloat16 → sm90) and at D = 8 in
   bfloat16 (tf32x3's other role) the kernel, SDPA and the plain version
   are timed in turns beside the card's bound for the same work, and the
   CUDA kernels SDPA runs are named from a profiler trace; then each
   backward kernel against ``flash_backward_reference`` on the same (O,
   LSE, dO) at every checked shape of its route (``flash_bwd_sm90``:
   bfloat16 at D in 16, 32, 64, 128, ragged T, packed views;
   ``flash_bwd_tf32x3``: float32 at every head dim and bfloat16 at D = 8),
   with max|err| of dQ, dK and dV and the share of each limit used, and at
   the encoder's shape in bfloat16 ``flash_bwd_sm90``, ``flash_bwd`` (named:
   no route takes it) and SDPA's backward timed in turns, in float32
   ``flash_bwd_tf32x3``, ``flash_bwd`` and SDPA's backward, and at D = 8 in
   bfloat16 ``flash_bwd_tf32x3`` and SDPA's backward, each beside the plain
   version;
3. serve leg at cluster scale: 10,000 hosts × 16 probes through the
   topology engine, one flush on the card, then waves of 256 decisions ×
   15 candidates joined (rtt affinity) and ranked by a [19, 128, 128, 1]
   MLP loaded from npz bytes — rankings against ``rank_order``, scores and
   affinities against the same port on the CPU;
4. scheduler leg at cluster scale: the same 10,000 hosts × 16 probes in
   the topology engine, a swarm of 40 tasks × 256 peers (a quarter
   succeeded, the rest running with one parent each) in the scheduler's
   resource model, and a [19, 128, 128, 1] MLP installed by the
   ``ModelRefresher`` from an in-process manager; then waves of 256
   running children through ``Scheduling.find_candidate_parents_wave`` →
   ``MLEvaluator.evaluate_wave`` → ``ScoringService`` → ``MLPScorer`` on
   the card. Every checked wave must stay on the ``serving`` rung with no
   demotion, rank each decision by ``rank_order`` of its card scores, and
   match the same waves run on the CPU (candidate sets equal, scores
   within 2e-2);
5. trainer leg: one upload round of the scheduler's record sink (1
   file × 100 MiB of binary train blocks in ``main``, 11 at the leg's
   default, ~1.8 M download records; and the serve leg's probe graph as
   ~40,000 topology records) fed through
   ``TrainerService.Train`` in 128 MiB chunks; ``Training`` as the trainer
   server builds it from its defaults fits the MLP on the streamed path
   (pinned buffers, a side-stream copy stage, 2 passes), the GNN (40
   epochs in ``main``, 60 at the leg's default) and the GRU (its newest
   10,000 sequences in ``main``, ``GRU_MAX_SEQUENCES`` at the leg's
   default) at once on the card and
   uploads all three through
   ``CreateModel`` to the in-process manager shortcut (``_Manager``); each
   holdout mse must beat the
   mean predictor's; the refresher then installs the three models — the
   GNN in the serving slot (embedded at swap time over the engine's
   export), the GRU behind bad-node detection — and scheduler waves run
   on them (one checked wave in ``main``; rung ``serving``, ``model_kind() == "gnn"``, no demotion
   after the warm-up wave, scores as a CPU run's whose GNN pair head
   rounds as the card's does, held in ``hold_served_gnn``'s two stages);
   a reduced streamed fit
   and a reduced GRU fit are held against the CPU's (``FIT_TOL``,
   ``GRU_FIT_TOL``), and ~20 superbatches are traced for the device's
   idle share. The round runs with a ``checkpoint_dir``: the GNN fit
   snapshots each of its epochs (timed), and no snapshot directory
   may be left after the round;
5a. resume phase: the crash drill of the fits — ``train_gnn`` on the
   serve leg's probe graph and ``train_mlp`` at [19, 128, 128, 1] on the
   trainer leg's pairs, 3 epochs each in ``main`` (4 at the phase's
   default), in two spawned processes on the
   card with a ``checkpoint_dir`` and ``DF_FAULTS=trainer.fit_step=abort#2``:
   each must die by SIGKILL, the newest snapshot restored onto the card
   must equal what the child saved bit for bit, and the fit resumed here
   runs the epochs after the second and lands on an uninterrupted card
   run (MLP within 1e-6;
   GNN within two uninterrupted runs' difference, 1e-6 where that is 0);
5b. federation phase: the trainer leg's upload group as 4 scheduler
   hosts' shards (3 binary, 1 CSV, decoded by the native decoder) in
   trainer storage;
   ``Training.federated_round`` on the card sends exactly one
   ``CreateModel`` (``federated_model_id_v1()``, hostname
   ``federated``), whose params must be ``fedavg_trees`` of the per-host
   fits refit here (within 1e-6 relative) and whose holdout mse must
   beat the mean predictor's;
6. preheat leg: a ``DemandWindow`` at its defaults (1,024 tasks × 32
   buckets of 10 s) with 8 rising series among flat ones; one
   ``PreheatPlanner`` sweep fits the GRU demand forecaster inline on the
   card (4 epochs in ``main``, the forecaster's 8 at the leg's default),
   forecasts every series, plans the rising ones and sends one
   ``CreateJob`` to the in-process manager shortcut carrying their task ids
   and ``recommend_seeds_by_rtt`` over the 10,000-host engine; the forecast
   on the card is held against its numpy version (``FORECAST_TOL``), and
   ``recommend_seeds`` ranks 64 candidate hosts with the trained GNN, as
   on the CPU;
7. server leg: the port's ``SchedulerServer`` (``algorithm="ml"``) and
   ``TrainerServer`` live over gRPC in this process on the card, with the
   port's ``ManagerServer`` as shipped (sqlite and ``fs`` object storage
   under the leg's scratch, the read-through cache, the telemetry plane,
   /metrics, the certificate authority when ``cryptography`` is there),
   and the daemons' side in 4 processes of its own (started with ``spawn``):
   10,000 hosts announce and sync 16 seeded probes each (160,000 edges)
   through ``SyncProbes``; 8 tasks × 256 peers run their ``AnnouncePeer``
   streams at 64 at once (a back-to-source seed per task, then children
   scheduled on earlier peers through ``Scheduling`` → ``MLEvaluator`` →
   ``ScoringService`` on a seeded MLP the refresher installed); the
   announcer uploads the records and the probe snapshot to the trainer,
   whose fits land three ``CreateModel``. Each upload — the seeded MLP's
   too — lands as an inactive version that a poll must not install; the
   leg activates the seeded MLP with gRPC ``UpdateModel`` and the three
   trained models over the manager's REST front (``PUT
   /api/v1/models/:id/versions/:v/state``), as an operator would, and the
   next poll installs them (activation → installed timed); then
   32 more children are scored by the trained GNN with the GRU behind
   bad-node detection. Every decision must be a legal parent set or a
   legitimate back-to-source, none may drop below the serving rung after
   the warm-up, each order is ``rank_order`` of its card scores, and every
   served call is rescored on the CPU (MLP within 2e-2; GNN within 5e-2 of
   a CPU run whose pair head rounds as the card's does, and in
   ``hold_served_gnn``'s two stages; the gap to a float32 head printed
   beside).
   Both servers run as shipped with a manager: telemetry to the manager's
   plane every 15 s and /metrics on a port of their own; after the last
   decision each pushes once more and must have pushed at least
   ⌊leg s / 15⌋ − 1 times with no failure, the counters the leg counted
   itself must read alike in the plane, both expositions (text and
   OpenMetrics, every line parsed) and the leg's count, /healthz must
   answer 200 with every service ``ok`` and each /debug endpoint 200 with
   JSON; ``build_payload`` ms, payload bytes and scrape ms are printed;
   the plane's snapshot must name both reporters, and so must the REST
   front's ``GET /api/v1/telemetry``, whose ``GET /`` must serve the
   port's console page; the manager's /healthz carry the SLO section, and
   ``IssueCertificate`` sign a CSR whose chain verifies against the CA;
7a. native phase: the native CSV decoder (``csrc/dfnative.cc``, built with
   g++ at first use, its seconds printed): decode MiB/s of one 100 MiB
   download CSV through ``decode_pairs_file`` and through
   ``stream_pairs_file`` over the default producers, bit for bit against
   the numpy route on an 8 MiB prefix, the serve leg's probe graph as a
   topology CSV through ``build_probe_graph_file`` equal to
   ``build_probe_graph``, and that upload round through ``Training`` on the
   card, whose MLP must take the streamed fit and beat the mean predictor;
7b. mesh phase, over an NCCL process group of one rank: ``train_mlp``
   over a dp mesh against the fit without one (within 1e-6), the sharded
   embed and forward over a gp mesh on the serve leg's 10,000-host,
   160,000-edge graph against the unsharded ones at float32 (within
   1e-5; the bf16 gap against ``GNNScorer`` printed),
   ``train_gnn_sharded`` for 120 full-batch steps beating its mean
   predictor and reading the unsharded fit's holdout (within 5e-2
   relative), and ``fedavg_psum`` against ``fedavg_trees``;
7c. download leg: the P2P download path — the port's ``ManagerServer``,
   the port's ``SchedulerServer`` (``algorithm="ml"`` on the card, a seeded
   MLP uploaded inactive, activated with ``UpdateModel`` and then installed
   by the refresher, seed peers enabled) and 8 of the port's daemons, each
   ``python -m dragonfly2_torch.client.daemon`` in its own interpreter at
   ``DaemonConfig``'s defaults (one seed peer, 7 peers; probes every 2 s
   into the topology engine through ``SyncProbes``) with no static
   scheduler list: each finds the scheduler through the manager's
   ``ListSchedulers`` (the searcher keeps a decoy cluster's scheduler
   from them; the operator scopes the default cluster and creates the
   decoy over the manager's REST front), and the seed peer registers
   with ``UpdateSeedPeer``; all
   against an origin in
   a process of its own serving a seeded 1 GiB file: the 7 peers ``dfget``
   it at once, ``dfcache`` stats and exports it on one peer, and an image
   preheat job (an OCI index → the ``linux/amd64`` manifest of 4 layers of
   64 MiB), created with ``POST /oapi/v1/jobs`` under a personal access
   token minted over REST and read back with ``GET /oapi/v1/jobs/:id``,
   runs through the scheduler's job worker, whose manifest fetch
   goes through the port's source client, before one peer pulls a layer.
   Every output's sha256 must be the origin's, every decision served by
   the card's MLP on the ``serving`` rung, origin egress below 8× the file,
   one peer ≥ 90% of its bytes from peers, ≥ 7 download records, every
   probed pair in the engine, and the preheated layer's pull 0 origin
   bytes;
7d. fleet leg: the scheduler fleet — the port's ``ManagerServer`` with
   its embedded RESP KV server, 3 schedulers, each ``python -m
   dragonfly2_torch.scheduler`` in its own process on the card
   (``algorithm="ml"``, ``fleet_enabled`` with leases of 3 s renewed
   every 1 s, swarm replication every 0.25 s, the seeded MLP uploaded
   inactive and activated through the manager), a seed peer and 7 peers
   of the port's daemons following the leases (``kv_address``), and a
   1 GiB origin: the fleet must form (3 leases, ``ListSchedulers`` and
   every daemon's ``fleet_members`` reading them); 6 peers pull the file
   at once and the task's ring owner gets a real SIGKILL mid-burst, once
   its replica at the settled epoch holds 2 or more peers; the last
   peer pulls it after the kill and must land on the ring successor,
   which must have adopted the dead owner's swarm (the receipt
   ``swarm:adopt:<task>``), name a parent of the dead owner's era and
   serve the decision with its MLP on the card; no failover may fall back
   to the origin and every blackout must stay below 12 s; a third
   scheduler gets SIGTERM and its lease must be gone within the 3 s
   lease, after which ``ListSchedulers`` names the successor alone;
7e. ab leg: the ``ml`` evaluator's yardsticks on the card
   (``chip_smoke.ab_leg``), each tool at its defaults: the serving soak
   (32 threads × 20 decisions over 12 candidates, per call against the
   batched scoring service) and the wave soak (waves of 8 against one
   decision a call) on the port's ``MLPScorer``, then the A/B harness:
   10 in-process daemons, 5 of them slow, pull 6 tasks × 4 pieces under
   the default evaluator, their records are uploaded, fitted on the card
   and activated in the port's manager, and the refresher's MLP on the
   card steers the same pulls through the scoring service; then the GRU
   A/B (6 daemons, 8 training tasks, 5 measured tasks × 6 pieces with a
   degrading parent, without and with the GRU). Every scorer must sit on
   the card, no soak may lose a decision, waves must rank as per-peer
   decisions, phase 2 must take the service's batches, each A/B's arms
   must count the same pieces and the card's MLP must take a smaller
   share of pieces from slow parents than the default evaluator (one
   re-measurement allowed); the soaks' throughput and p99 gates, the
   p50s and the GRU's verdict are printed with their verdict;
8. encoder leg at full width: the piece-sequence transformer (model_dim
   256, 4 heads, 4 layers) on B = 2, T = 8192 with flash attention, against
   the plain ``local_attention``: once in bfloat16, which must launch
   ``flash_fwd_sm90`` once per layer and ``flash_fwd_tf32x3`` never, and
   once in float32, which must launch ``flash_fwd_tf32x3`` once per layer
   and ``flash_fwd_sm90`` never;
9. encoder-gradient leg at the same width: ``apply_transformer`` with
   ``make_ulysses_attention(..., use_kernel=True)`` over an sp = 1 NCCL
   process group, a seeded loss and ``backward()``, in bfloat16 and in
   float32: each step must launch the forward kernel and the backward
   kernel of its route (``flash_bwd_sm90`` in bfloat16, ``flash_bwd_tf32x3``
   in float32) once per layer and nothing else, every gradient must be finite and
   within ``ENCODER_GRAD_TOL`` (``ENCODER_GRAD_QK_TOL`` for wq and wk) of
   the same step with ``local_attention`` under autograd; the step's wall
   and its peak memory are printed beside ``local_attention``'s.

The line before the last holds the kernels' table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. Weights and data are random, made from seeds.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import random
import re
import secrets
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dragonfly2_torch import _build
from dragonfly2_torch.models.attention import apply_transformer, init_transformer
from dragonfly2_torch.models.gru import init_gru
from dragonfly2_torch.models.mlp import apply_mlp, init_mlp
from dragonfly2_torch.ops import flash
from dragonfly2_torch.ops.ulysses import make_ulysses_attention
from dragonfly2_torch.parallel import make_mesh
from dragonfly2_torch.preheat import planner as preheat_planner
from dragonfly2_torch.preheat.demand import DemandWindow
from dragonfly2_torch.preheat.forecast import DemandForecaster
from dragonfly2_torch.schema import records as R
from dragonfly2_torch.schema import synth, wire
from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import GRU_FEATURE_DIM, MLP_FEATURE_DIM, build_probe_graph
from dragonfly2_torch.scheduler import metrics as scheduler_metrics
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler import wave
from dragonfly2_torch.scheduler.evaluator import MLEvaluator
from dragonfly2_torch.scheduler.networktopology import NetworkTopology
from dragonfly2_torch.scheduler.model_refresher import (
    ManagerUploader,
    ModelRefresher,
    PlainRequests,
)
from dragonfly2_torch.scheduler.scheduling import Scheduling
from dragonfly2_torch.scheduler.seed_placement import recommend_seeds, recommend_seeds_by_rtt
from dragonfly2_torch.scheduler.serving import ScoringService
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.trainer import metrics as M_T
from dragonfly2_torch.trainer import serving as trainer_serving
from dragonfly2_torch.trainer.ingest import holdout_mask, stream_train_mlp
from dragonfly2_torch.trainer.serving import (
    GNNScorer,
    GRUScorer,
    MLPScorer,
    deserialize_params_auto,
    serialize_params,
)
from dragonfly2_torch.trainer.service import PlainMessages, TrainerService
from dragonfly2_torch.trainer.storage import TrainerStorage
from dragonfly2_torch.trainer.train import FitConfig, GNNFitConfig, _batch_steps, _split_eval, train_gru
from dragonfly2_torch.trainer.training import Training, TrainingConfig
from dragonfly2_torch.utils import flight
from dragonfly2_torch.utils.idgen import gnn_model_id_v1, gru_model_id_v1, mlp_model_id_v1, task_id_v1
from dragonfly2_torch.utils.kvstore import KVStore
from dragonfly2_torch.weights import module_tree

# NVIDIA H100 SXM data sheet, dense rates. A float32-accurate product is
# fastest as 3xTF32 on the tensor cores: three TF32 products at 495 TFLOP/s
# (the CUDA cores' float32 rate is 67 TFLOP/s).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
# exponentials: 16 per clock per SM on the special-function units, 3.9 T/s
# (FlashAttention-3, Shah et al. 2024; CUDA programming guide throughputs)
PEAK_EXP_PER_S = 3.9e12

# O is held per element as |o - ref| <= atol + rtol·|ref|: float32 leaves
# room for another summation order only, bfloat16 for the two f32 sums
# landing on either side of a rounding point (2^-7·|ref| is one bf16 step)
# and one step more. flash_fwd_sm90 rounds the softmax weights P to bf16
# before P·V; that moves O by at most 2^-8·(P·|V|)/l, which its limit adds
# (``flash.p_rounding_term``). LSE is float32 on both sides.
FLASH_O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}
P_ROUNDING = 2**-8
FLASH_LSE_TOL = 1e-4
# (B, T, H, D, causal, dtype, packed q/k/v) for flash_fwd_tf32x3: the
# reference's on-chip set in float32 and the bf16 D = 8 case, long heads
# of 16 and 128, one row and a packed projection; the encoder's float32
# shape and bf16 D = 8 at T = 8192 are checked and timed after these
TF32X3_SHAPES = [
    (2, 512, 4, 64, True, torch.float32, False),
    (2, 200, 4, 64, True, torch.float32, False),  # ragged tail
    (1, 333, 2, 32, False, torch.float32, False),  # odd length, non-causal
    (1, 96, 8, 128, True, torch.float32, False),  # short sequence, wide head
    (2, 100, 4, 8, True, torch.float32, False),
    (2, 100, 4, 8, True, torch.bfloat16, False),
    (1, 4096, 2, 16, True, torch.float32, False),
    (1, 4096, 2, 128, True, torch.float32, False),
    (1, 1, 2, 64, False, torch.float32, False),  # T = 1
    (2, 300, 4, 64, True, torch.float32, True),  # views of one [B, T, 3, H, D] projection
]
# (B, T, H, D, dtype, packed) whose tf32x3 pre-passes (the forward's and
# the backward's) are held bit for bit
PREPASS_SHAPES = [
    (2, 8192, 4, 64, torch.float32, False),
    (2, 300, 4, 64, torch.float32, True),
    (1, 333, 2, 128, torch.float32, False),
    (2, 8192, 4, 8, torch.bfloat16, False),
]
# (B, T, H, D, causal, packed q/k/v) for flash_fwd_sm90 in bf16; the
# encoder's own shape is checked and timed after these
SM90_SHAPES = [
    (2, 512, 4, 64, True, False),
    (2, 512, 4, 64, False, False),
    (1, 300, 2, 128, True, False),
    (1, 333, 2, 32, False, False),  # ragged
    (1, 77, 2, 16, False, False),
    (2, 300, 4, 64, True, True),  # views of one [B, T, 3, H, D] projection
]
ENCODER = dict(in_dim=GRU_FEATURE_DIM, model_dim=256, num_heads=4, num_layers=4)
ENCODER_BT = (2, 8192)
ENCODER_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
D8_BF16 = (2, 8192, 4, 8)  # tf32x3's bf16 role at the encoder's B, T and H
KERNEL_NAMES = {
    "sm90": "flash_fwd_sm90",
    "tf32x3": "flash_fwd_tf32x3",
    "bwd": "flash_bwd",
    "bwd_sm90": "flash_bwd_sm90",
    "bwd_tf32x3": "flash_bwd_tf32x3",
}
# the libraries whose SASS must hold wgmma (flash_bwd runs on the CUDA cores)
WGMMA_LIBRARIES = ("flash_fwd_sm90", "flash_fwd_tf32x3", "flash_bwd_sm90", "flash_bwd_tf32x3")
# The backward kernel's dQ, dK, dV against flash_backward_reference on the
# same (q, k, v, O, LSE, dO), per element |g - ref| <= rtol·|ref| +
# atol·max|ref| as (rtol, atol). float32: both sum up to T products in
# float32 in other orders (the plain version sits within 0.06 of this limit
# of a float64 backward on the CPU at T = 2048); bfloat16: both round the
# same float32 values, which may land on either side of a rounding point —
# one step (2^-7·|ref|) and one more. flash_bwd_sm90 also rounds P and dS
# to bf16 before the dV, dK and dQ products; that moves each gradient by at
# most 2^-8 times its term of ``flash.bwd_rounding_terms``, which its limit
# adds (pinned by a CPU emulation in tests/test_torch_flash_bwd.py).
# flash_bwd_tf32x3 keeps BWD_TOL as it is: every product in 3xTF32 with P
# and dS split before theirs (a CPU emulation stays inside it, one TF32
# product leaves it, in the same file).
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2**-6, 1e-5)}
# (B, T, H, D, causal, dtype, packed q/k/v): every head dim in both types,
# ragged T, causal or not, views of one packed projection, each through the
# backward kernel of its route (bf16 at D >= 16 → flash_bwd_sm90, float32
# and bf16 at D = 8 → flash_bwd_tf32x3); the
# encoder's shape is checked and timed after these
BWD_SHAPES = [
    (2, 200, 4, 64, True, torch.float32, False),  # ragged tail
    (2, 200, 4, 64, True, torch.bfloat16, False),
    (1, 333, 2, 32, False, torch.float32, False),  # odd length, non-causal
    (1, 333, 2, 32, False, torch.bfloat16, False),
    (1, 96, 8, 128, True, torch.float32, False),  # short sequence, wide head
    (1, 300, 2, 128, False, torch.bfloat16, False),
    (1, 1000, 2, 128, True, torch.bfloat16, False),  # several key tiles at one warpgroup
    (2, 100, 4, 8, True, torch.float32, False),
    (2, 100, 4, 8, True, torch.bfloat16, False),  # the tf32x3 forward's bf16 role
    (1, 77, 2, 16, False, torch.bfloat16, False),
    (1, 70, 2, 16, True, torch.float32, False),
    (2, 300, 4, 64, True, torch.bfloat16, True),  # views of one [B, T, 3, H, D] projection
    (1, 4096, 2, 64, True, torch.float32, False),
]
# The encoder's gradients with flash (kernels forward and backward) against
# the same with local_attention under autograd on the card, per parameter
# as ||g - ref|| / ||ref||. float32: the kernels keep float32 limits, so
# only summation orders differ (3e-5 in a CPU emulation at T = 1024). In
# bfloat16, δ = rowsum(dO ⊙ O) reads the bf16 O, as the reference's
# _blockwise_bwd does, where autograd through local_attention takes the
# float32 P: at this init dS = P ⊙ (dP − δ) cancels to a small part of its
# terms, so O's rounding moves dQ and dK — the gradients of wq and wk —
# far more than anything else (0.21 at T = 1024 and 0.34 at T = 4096 in a
# CPU emulation of the sm90 forward, 0.01 with δ from a float32 O); every
# other parameter stays at a few 1e-3.
ENCODER_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
ENCODER_GRAD_QK_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.75}
MLP_DIMS = [MLP_FEATURE_DIM, 128, 128, 1]  # the trainer's default MLP
# bfloat16 products on the card against float32 on the CPU
SCORE_TOL = 2e-2
# the served GNN's scores, card against CPU. The SAGE layers take bf16
# inputs on both; the pair head takes bf16 inputs on the card (192 of them,
# [h_src, h_dst, h_src * h_dst]) and rounds its 64 hidden activations to
# bf16, so the CPU run the card is held to does so too
# (``gnn_head_like_the_card``). What is left is the order of the float32
# sums: a hidden activation within that order's error of a bf16 rounding
# midpoint may round to the other neighbour on the card, moving the score
# by |w| times the bf16 spacing there (on an H100, 12 of the trainer
# leg's 11,435 scores moved past 1e-5, up to 5.9e-4, and a flat limit of
# 1e-2 failed once: it holds by chance). So a served score is held in two
# stages without that chance (``hold_served_gnn``): the card's node
# embeddings against the CPU's within GNN_EMB_TOL (read 1.8e-7 and
# 2.1e-5; the limit leaves room for SAGE activations rounding the other
# way), and its scores against the CPU's head over those same embeddings
# within GNN_HEAD_TOL beyond what the hidden units that may round either
# way can move (``gnn_head_band``). The end-to-end
# gap to the CPU run is held to the 5e-2 it always was and printed beside
# the gap to a float32 head (0.018–0.0533, log-ms scores near 3)
GNN_SCORE_TOL = 5e-2
GNN_EMB_TOL = 1e-3
GNN_HEAD_TOL = 1e-5
# one upload round of the scheduler's record sink — 10 rotated backups and
# the active file, 100 MiB each (dragonfly2_tpu/scheduler/storage.py:76-77)
# — shipped in the announcer's 128 MiB chunks (scheduler/announcer.py:38)
UPLOAD_FILES, FILE_MIB, UPLOAD_CHUNK = 11, 100, 128 << 20
TRAINER_IP, TRAINER_HOST = "10.0.0.2", "scheduler-0"
TRAINER_WORK = Path(__file__).resolve().parent / "build" / "trainer_leg"
# the server leg's phase 1 before the servers pushed telemetry and served
# /metrics, and the trainer leg's round before the GNN took snapshots
# (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
SERVER_BEFORE_TELEMETRY = {"decisions_per_s": 84.6, "decide_ms_p50": 596.7, "decide_ms_p99": 1229.5}
TRAINER_ROUND_BEFORE_SNAPSHOTS_S = 29.1
# a streamed fit on the card (bfloat16 matmul inputs) against the same fit
# on the CPU (float32): each step's loss and the holdout mse, relative
FIT_TOL = 5e-2  # twice what bf16 inputs emulated on the CPU may move them (tests/test_torch_ingest.py)
# the GRU computes in float32 on both (TF32 off): only summation order
# differs, a few ulps a step
GRU_FIT_TOL = 1e-3
# the trainer leg's one cut: the GRU keeps the newest this many of the
# round's sequences (the default 1,000,000 would take its fit past the
# GNN's, see PERF.md); its card-vs-CPU check fits this many
GRU_MAX_SEQUENCES = 40_000
GRU_CHECK_SEQUENCES = 8192
# the preheat leg: rising series among the demand window's flat ones, the
# hosts recommend_seeds ranks with the trained GNN, and the forecast on the
# card against its numpy version (tests/test_preheat.py's limit)
PREHEAT_HOT = 8
PREHEAT_CANDIDATES = 64
FORECAST_TOL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, device: torch.device) -> float:
    """Median host time of ``fn()`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def flash_bound_ms(b: int, t: int, h: int, d: int, causal: bool, dtype) -> "tuple[float, str]":
    """Least time for the attention on this card, the largest of: the
    products over the type's peak rate, one exponential per (query, key)
    pair over the special-function rate, and q, k, v, o and LSE moved once
    over the memory rate."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * t * h * d * elem + 4 * b * h * t
    ops_ms = max(
        flash_flops(b, t, h, d, causal) / PEAK_FLOPS[dtype],
        b * h * flash_pairs(t, causal) / PEAK_EXP_PER_S,
    ) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flash_pairs(t: int, causal: bool) -> int:
    """(query, key) pairs of one head: below the diagonal when causal."""
    return t * (t + 1) // 2 if causal else t * t


def flash_flops(b: int, t: int, h: int, d: int, causal: bool) -> int:
    """Two [T, T]·D products (scores and P·V) over the pairs."""
    return 4 * b * h * d * flash_pairs(t, causal)


def build_kernels() -> None:
    """Every library built at once, each timed, with ptxas's report per
    instantiation and the wgmma count of each tensor-core library's SASS."""

    def timed_load(name):
        t0 = time.perf_counter()
        _build.load(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        for name, secs in pool.map(timed_load, _build.SOURCES):
            print(f"build: {name} in {secs:.1f}s")
    for name in _build.SOURCES:
        for fn, regs, spills, fences in ptxas_report(_build.build_log(name)):
            print(f"  {name} {fn}: {regs} registers, {spills}, {fences} wgmma fences added by ptxas")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"  {cuobjdump} not found: HGMMA instructions not counted")
        return
    for name in WGMMA_LIBRARIES:
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, check=True,
        ).stdout
        hgmma = re.findall(r"\bHGMMA\.(\S+)", sass)
        kinds = sorted(set(hgmma))
        print(f"  {name}: {len(hgmma)} HGMMA instructions in its SASS ({', '.join(kinds[:6])}"
              f"{', ...' if len(kinds) > 6 else ''})")
        check(len(hgmma) > 0, f"{name} compiled without wgmma")


def ptxas_report(log: str) -> "list[tuple[str, str, str, int]]":
    """(instantiation, registers, spills, wgmma fences ptxas had to add) per
    kernel in an ``nvcc -Xptxas -v`` log; the instantiation is named by its
    kernel and its template's int and bool arguments."""
    injected: dict = {}
    for fn in re.findall(r"warpgroup\.arrive is injected .* in function '(\S+)'", log):
        injected[fn] = injected.get(fn, 0) + 1
    out, name, mangled, spills = [], "?", "", "?"
    for line in log.splitlines():
        fn = re.search(r"Function properties for (\S+)", line)
        if fn:
            mangled = fn.group(1)
            args = re.findall(r"L[ib](\d+)E", mangled)
            if "bfloat16" in mangled:
                args.append("bf16")
            name = f"{kernel_base_name(mangled)}<{','.join(args)}>"
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if sp:
            spills = f"{sp.group(1)} B spill stores, {sp.group(2)} B spill loads"
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.append((name, regs.group(1), spills, injected.get(mangled, 0)))
    return out


def kernel_base_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol: the length-prefixed
    identifier that ends in ``kernel`` (empty when there is none)."""
    for m in re.finditer(r"(?=(\d{1,3}))", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start : start + int(m.group(1))]
        if ident.endswith("kernel") and ident.isidentifier():
            return ident
    return ""


def random_qkv(b, t, h, d, dtype, seed, packed=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = torch.randn((b, t, 3, h, d), generator=g, device="cuda").to(dtype)
        return qkv.unbind(dim=2)
    return [torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype) for _ in range(3)]


def shape_name(q, causal=None) -> str:
    b, t, h, d = q.shape
    return (
        f"B={b} T={t} H={h} D={d}{'' if causal is None else f' causal={causal}'}"
        f" {str(q.dtype)[6:]}{'' if q.is_contiguous() else ' strided'}"
    )


def prepass_phase() -> dict:
    """The tf32x3 pre-passes alone (the forward's, ``tf32x3_prepass``, and
    the backward's, ``tf32x3_bwd_prepass``) against their plain splits, bit
    for bit, at every shape → {kernel: its pre-pass's device time at the
    first shape (the encoder's), in ms}."""
    times = {}
    for i, (b, t, h, d, dtype, packed) in enumerate(PREPASS_SHAPES):
        q, k, v = random_qkv(b, t, h, d, dtype, seed=300 + i, packed=packed)
        do = random_qkv(b, t, h, d, dtype, seed=350 + i)[0]
        for kernel, run, plain, args in (
            ("tf32x3", flash.tf32x3_prepass, flash.tf32x3_prepass_reference, (q, k, v)),
            ("bwd_tf32x3", flash.tf32x3_bwd_prepass, flash.tf32x3_bwd_prepass_reference,
             (q, k, v, do)),
        ):
            with torch.no_grad():
                got = run(*args)
                torch.cuda.synchronize()
                want = plain(*args)
            same = len(got) == len(want) and all(
                g.shape == w.shape and torch.equal(g.view(torch.int32), w.contiguous().view(torch.int32))
                for g, w in zip(got, want)
            )
            print(f"{kernel} pre-pass {shape_name(q)}: bit for bit as its plain split: {same}")
            check(same, f"{kernel} pre-pass {shape_name(q)} differs from its plain split")
            if kernel not in times:
                with torch.no_grad():
                    times[kernel] = cuda_ms(lambda: run(*args), 20)
                print(f"{kernel} pre-pass {shape_name(q)}: {times[kernel]:.4f} ms")
    return times


def flash_case(q, k, v, causal, kernel: str) -> dict:
    """One kernel at one shape against the plain version, with the limit of
    that kernel → {"max_abs_err", "bound_ms", "bound_by"}."""
    b, t, h, d = q.shape
    with torch.no_grad():
        o, lse = flash.launch_kernel(q, k, v, causal, kernel)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_attention_reference(q, k, v, causal=causal)
        atol, rtol = FLASH_O_TOL[q.dtype]
        limit = atol + rtol * o_ref.float().abs()
        if kernel == "sm90":
            limit += P_ROUNDING * flash.p_rounding_term(q, k, v, causal)
    diff = (o.float() - o_ref.float()).abs()
    err_o = diff.max().item()
    o_share = (diff / limit).max().item()  # worst share of the per-element limit (<= 1 passes)
    o_rel_rms = err_o / o_ref.float().pow(2).mean().sqrt().item()
    err_lse = (lse - lse_ref).abs().max().item()
    name = f"{KERNEL_NAMES[kernel]} {shape_name(q, causal)}"
    p_term = f"+{P_ROUNDING:g}*(P|V|)/l" if kernel == "sm90" else ""
    print(
        f"{name}: max|err| O={err_o:.3g} (max|err|/rms(ref)={o_rel_rms:.3g}; per element"
        f" {o_share:.3g} of the limit {atol:g}+{rtol:g}*|ref|{p_term})"
        f" LSE={err_lse:.3g} ({err_lse / FLASH_LSE_TOL:.3g} of the limit {FLASH_LSE_TOL:g})"
    )
    check(o.shape == q.shape and o.dtype == q.dtype and torch.isfinite(o).all().item(), name)
    check(o_share <= 1.0, f"{name}: kernel's O disagrees with the plain version")
    check(err_lse <= FLASH_LSE_TOL, f"{name}: kernel's LSE disagrees with the plain version")
    bound, by = flash_bound_ms(b, t, h, d, causal, q.dtype)
    return {"max_abs_err": max(err_o, err_lse), "bound_ms": bound, "bound_by": by}


def sdpa(q, k, v, causal):
    """SDPA on [B, T, H, D] tensors already moved to its [B, H, T, D] layout."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)


def flash_times(q, k, v, causal, kernel: str, rounds: int = 3) -> dict:
    """Device times at one shape: the kernel and SDPA in turns, ``rounds``
    times (medians reported), then the plain version → {"ms",
    "library_ms", "plain_ms"}."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's layout
    ms, lib = [], []
    with torch.no_grad():
        for _ in range(rounds):
            ms.append(cuda_ms(lambda: flash.launch_kernel(q, k, v, causal, kernel), 20))
            lib.append(cuda_ms(lambda: sdpa(qt, kt, vt, causal), 20))
        plain = cuda_ms(lambda: flash.flash_attention_reference(q, k, v, causal=causal), 3)
    return {"ms": statistics.median(ms), "library_ms": statistics.median(lib), "plain_ms": plain}


def sdpa_kernels(q, k, v, causal) -> "list[str]":
    """The CUDA kernels one SDPA call runs, by name from a profiler trace."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(qt, kt, vt, causal)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})


def flash_phase() -> dict:
    """Every checked shape of both kernels, then the timed calls: the
    encoder's shape in bfloat16 (sm90) and in float32 (tf32x3), and
    tf32x3's bfloat16 role at D = 8 → {row: its entry of the kernels' table,
    without ``launches``}."""
    for i, (b, t, h, d, causal, dtype, packed) in enumerate(TF32X3_SHAPES):
        flash_case(*random_qkv(b, t, h, d, dtype, seed=100 + i, packed=packed), causal, "tf32x3")
    for i, (b, t, h, d, causal, packed) in enumerate(SM90_SHAPES):
        qkv = random_qkv(b, t, h, d, torch.bfloat16, seed=200 + i, packed=packed)
        flash_case(*qkv, causal, "sm90")

    b, t = ENCODER_BT
    h = ENCODER["num_heads"]
    encoder = (b, t, h, ENCODER["model_dim"] // h)
    rows = {}
    for row, kernel, shape, dtype in (
        ("sm90", "sm90", encoder, torch.bfloat16),
        ("tf32x3", "tf32x3", encoder, torch.float32),
        ("tf32x3_d8_bf16", "tf32x3", D8_BF16, torch.bfloat16),
    ):
        q, k, v = random_qkv(*shape, dtype, seed=7)
        rows[row] = {**flash_case(q, k, v, True, kernel), **flash_times(q, k, v, True, kernel)}
        r = rows[row]
        print(
            f"{KERNEL_NAMES[kernel]} {shape_name(q, True)}: kernel_ms={r['ms']:.4f}"
            f" plain_ms={r['plain_ms']:.4f} library_ms(sdpa)={r['library_ms']:.4f}"
            f" ({r['ms'] / r['library_ms']:.2f}x) bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
            f" {flash_flops(*shape, True) / r['ms'] / 1e9:.1f} TFLOP/s,"
            f" {r['bound_ms'] / r['ms']:.2%} of the bound"
        )
        try:
            names = sdpa_kernels(q, k, v, True)
        except Exception as exc:  # the trace is a reading aid; the times above stand
            names = [f"no trace: {exc}"]
        print(f"  sdpa at {shape_name(q, True)} runs: {'; '.join(names) or 'no kernel seen'}")
    return rows


def bwd_bound_ms(b: int, t: int, h: int, d: int, causal: bool, dtype) -> "tuple[float, str]":
    """Least time for the attention backward on this card, the largest of:
    five products of 2·D operations per (query, key) pair (S, dP, dV, dK,
    dQ) over the type's peak, one exponential per pair over the
    special-function rate, and q, k, v, O, dO and LSE read and dQ, dK, dV
    written once over the memory rate."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 8 * b * t * h * d * elem + 4 * b * h * t
    pairs = b * h * flash_pairs(t, causal)
    ops_ms = max(10 * d * pairs / PEAK_FLOPS[dtype], pairs / PEAK_EXP_PER_S) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bwd_inputs(q, k, v, causal, seed):
    """O and LSE from the forward kernel the path takes, and a seeded
    cotangent dO."""
    with torch.no_grad():
        o, lse = flash.launch_kernel(q, k, v, causal)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return o, lse, torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)


def bwd_case(q, k, v, causal, seed, kernel: "str | None" = None) -> dict:
    """A backward kernel at one shape against its plain version on the same
    (O, LSE, dO), with the limit of that kernel → {"max_abs_err",
    "bound_ms", "bound_by"}. ``kernel`` defaults to the shape's route."""
    b, t, h, d = q.shape
    kernel = kernel or flash.bwd_kernel_for(q.dtype, d)
    o, lse, do = bwd_inputs(q, k, v, causal, seed)
    got = flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kernel)
    torch.cuda.synchronize()
    want = flash.flash_backward_reference(q, k, v, o, lse, do, causal)
    terms = (
        flash.bwd_rounding_terms(q, k, v, o, lse, do, causal) if kernel == "bwd_sm90" else (0, 0, 0)
    )
    rtol, atol = BWD_TOL[q.dtype]
    name = f"{KERNEL_NAMES[kernel]} {shape_name(q, causal)}"
    errs, shares = {}, {}
    for grad, g, w, term in zip(("dq", "dk", "dv"), got, want, terms):
        check(g.shape == q.shape and g.dtype == q.dtype and torch.isfinite(g).all().item(),
              f"{name}: {grad} shape, dtype or finiteness")
        diff = (g.float() - w.float()).abs()
        limit = rtol * w.float().abs() + atol * w.float().abs().max() + P_ROUNDING * term
        errs[grad] = diff.max().item()
        shares[grad] = (diff / limit).max().item()
    p_term = f" + {P_ROUNDING:g}*term" if kernel == "bwd_sm90" else ""
    print(
        f"{name}: max|err| " + " ".join(f"{g}={errs[g]:.3g} ({shares[g]:.3g} of the limit)" for g in errs)
        + f" (limit {rtol:g}*|ref| + {atol:g}*max|ref|{p_term})"
    )
    check(max(shares.values()) <= 1.0, f"{name}: the backward kernel disagrees with the plain version")
    bound, by = bwd_bound_ms(b, t, h, d, causal, q.dtype)
    return {"max_abs_err": max(errs.values()), "bound_ms": bound, "bound_by": by}


def bwd_times(q, k, v, causal, kernels, rounds: int = 3) -> dict:
    """Device times of the backward at one shape: each of ``kernels`` and
    SDPA's backward (on the same inputs in its layout) in turns, ``rounds``
    times (medians reported), then the plain version → {kernel: ms,
    "library_ms", "plain_ms"}."""
    o, lse, do = bwd_inputs(q, k, v, causal, seed=8)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    out = sdpa(qt, kt, vt, causal)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    times = {kern: [] for kern in (*kernels, "library_ms")}
    for _ in range(rounds):
        for kern in kernels:
            # flash_bwd takes ~11 ms a call at the encoder's shape, the others < 1
            reps = 5 if kern == "bwd" else 20
            times[kern].append(
                cuda_ms(lambda: flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kern), reps)
            )
        times["library_ms"].append(cuda_ms(library, 20))
    plain = cuda_ms(lambda: flash.flash_backward_reference(q, k, v, o, lse, do, causal), 2)
    return {**{key: statistics.median(ms) for key, ms in times.items()}, "plain_ms": plain}


def launch_split(q, k, v, causal, kernel: str) -> dict:
    """Device ms of each CUDA kernel one backward launch runs, from a
    profiler trace (a reading aid: {} when the trace shows none)."""
    o, lse, do = bwd_inputs(q, k, v, causal, seed=8)
    flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kernel)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kernel)
            torch.cuda.synchronize()
    except Exception as exc:  # the trace is a reading aid; the times of bwd_times stand
        print(f"  no trace: {exc}")
        # untraced, so that a fault of the kernel itself still raises here
        flash.launch_backward(q, k, v, o, lse, do, causal, kernel=kernel)
        torch.cuda.synchronize()
        return {}
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"\w*kernel\b", e.name)
            name = found.group(0) if found else e.name[:60]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return split


def bwd_phase() -> dict:
    """Each backward kernel at every checked shape of its route, then the
    timed calls: at the encoder's shape in bfloat16 ``flash_bwd_sm90`` (its
    route) and ``flash_bwd`` (named, for the comparison), in float32
    ``flash_bwd_tf32x3`` (its route) and ``flash_bwd`` (named), and at
    D = 8 in bfloat16 the same two, each checked and timed in turns with
    SDPA's backward; ``flash_bwd_tf32x3``'s launch split by kernel from a
    profiler trace → {row: its entry of the kernels' table, without
    ``launches``} for the rows ``bwd_sm90``, ``bwd_bfloat16``,
    ``bwd_tf32x3``, ``bwd_float32``, ``bwd_tf32x3_d8_bf16`` and
    ``bwd_d8_bf16``."""
    for i, (b, t, h, d, causal, dtype, packed) in enumerate(BWD_SHAPES):
        bwd_case(*random_qkv(b, t, h, d, dtype, seed=400 + i, packed=packed), causal, seed=500 + i)
    b, t = ENCODER_BT
    h = ENCODER["num_heads"]
    encoder = (b, t, h, ENCODER["model_dim"] // h)
    rows = {}
    for shape, dtype, kernels in (
        (encoder, torch.bfloat16, (("bwd_sm90", "bwd_sm90"), ("bwd", "bwd_bfloat16"))),
        (encoder, torch.float32, (("bwd_tf32x3", "bwd_tf32x3"), ("bwd", "bwd_float32"))),
        (D8_BF16, torch.bfloat16, (("bwd_tf32x3", "bwd_tf32x3_d8_bf16"), ("bwd", "bwd_d8_bf16"))),
    ):
        q, k, v = random_qkv(*shape, dtype, seed=9)
        times = bwd_times(q, k, v, True, [kern for kern, _ in kernels])
        if kernels[0][0] == "bwd_tf32x3":
            split = launch_split(q, k, v, True, "bwd_tf32x3")
            print(f"  {KERNEL_NAMES['bwd_tf32x3']} {shape_name(q, True)}, one launch by kernel: "
                  + "; ".join(f"{name} {ms:.4f} ms" for name, ms in split.items()))
        for kern, row in kernels:
            r = rows[row] = {
                **bwd_case(q, k, v, True, seed=10, kernel=kern),
                "ms": times[kern],
                "library_ms": times["library_ms"],
                "plain_ms": times["plain_ms"],
            }
            print(
                f"{KERNEL_NAMES[kern]} {shape_name(q, True)}: kernel_ms={r['ms']:.4f}"
                f" plain_ms={r['plain_ms']:.4f} library_ms(sdpa backward)={r['library_ms']:.4f}"
                f" ({r['ms'] / r['library_ms']:.2f}x) bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
                f" {10 * shape[3] * shape[0] * shape[2] * flash_pairs(shape[1], True) / r['ms'] / 1e9:.1f}"
                f" TFLOP/s (five products), {r['bound_ms'] / r['ms']:.2%} of the bound"
            )
    return rows


PROBED_AT = 1_000_000.0  # the engines' clock: probes land a minute before


def probe_graph(hosts: int, probes: int, rng: np.random.Generator):
    """Probe measurements drawn from ``rng``: each host probes ``probes``
    distinct other hosts; the RTT follows seeded latent host coordinates
    in the unit square (the reference synth's model: 1 ms + 80 ms ×
    distance + exponential noise of mean 2 ms), so it is learnable from
    host identity → (host ids, a function that feeds them into a new
    engine on a device, the probed peers [hosts, probes] and their RTTs
    in ns). ``fed.coords`` keeps the latent coordinates, for a leg that
    makes transfers take longer between farther hosts."""
    ids = [f"host-{i:05d}" for i in range(hosts)]
    peers = np.stack([rng.choice(hosts - 1, probes, replace=False) for _ in range(hosts)])
    peers += peers >= np.arange(hosts)[:, None]  # distinct peers, no self probe
    coords = rng.uniform(0, 1, (hosts, 2))
    dist = np.linalg.norm(coords[:, None, :] - coords[peers], axis=-1)
    rtts = ((1.0 + 80.0 * dist + rng.exponential(2.0, (hosts, probes))) * 1e6).astype(np.int64)
    cfg = TopologyConfig(flush_threshold=10**9, max_pending=hosts * probes + 1)

    def fed(dev):
        eng = TopologyEngine(cfg, device=dev, clock=lambda: PROBED_AT)
        for i in range(hosts):
            for j, rtt in zip(peers[i], rtts[i]):
                eng.enqueue(ids[i], ids[int(j)], int(rtt), created_at=PROBED_AT - 60.0)
        return eng

    fed.coords = coords
    return ids, fed, peers, rtts


def serve_leg(device, hosts=10_000, probes=16, waves=(256, 15), repeats=20, seed=0) -> dict:
    """Topology flush + wave join + ranked MLP scoring on ``device``, held
    against the same port on the CPU."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    now = PROBED_AT
    eng = fed(device)
    t0 = time.perf_counter()
    eng.flush(now=now)
    sync(device)
    first_flush_ms = (time.perf_counter() - t0) * 1e3
    refresh_ms = wall_ms(lambda: eng.flush(now=now), 3, device)
    check(eng._D.device.type == device.type, "D is not on the engine's device")
    stats = eng.stats()
    check(stats["edges"] == hosts * probes, "edges lost in the flush")
    print(
        f"serve[{device}]: flush of {stats['edges']} edges / {stats['hosts']} hosts"
        f" first_ms={first_flush_ms:.1f} refresh_ms={refresh_ms:.1f}"
    )

    mlp = init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS)
    blob = serialize_params(mlp)
    scorer = MLPScorer(deserialize_params_auto(blob), device=device)
    check(scorer.feature_dim == MLP_FEATURE_DIM, "scorer feature_dim")

    W, C = waves
    children = rng.integers(0, hosts, W)
    cands = np.stack([rng.choice(hosts, C, replace=False) for _ in range(W)])
    src = [ids[c] for c in np.repeat(children, C)]
    dst = [ids[p] for p in cands.reshape(-1)]
    dst[::97] = ["host-unknown"] * len(dst[::97])  # the 0.0 missing value
    host_stats = rng.random((W * C, MLP_FEATURE_DIM - 1)).astype(np.float32)
    counts = [C] * W
    seg = wave.segment_ids(counts)

    def decide():
        aff = eng.rtt_affinity_pairs(src, dst)
        feats = np.concatenate([host_stats, aff[:, None]], axis=1)
        scores, order = scorer.predict_ranked(feats, seg)
        return aff, feats, scores, order, wave.split_order(order, counts)

    aff, feats, scores, order, rankings = decide()
    check(np.array_equal(order, wave.rank_order(scores, seg)), "rankings differ from rank_order")
    check(len(rankings) == W and all(sorted(r) == list(range(C)) for r in rankings), "rankings")
    check(np.isfinite(scores).all() and scores.shape == (W * C,), "scores not finite")
    wave_ms = wall_ms(decide, repeats, device)
    join_ms = wall_ms(lambda: eng.rtt_affinity_pairs(src, dst), repeats, device)
    score_ms = wall_ms(lambda: scorer.predict_ranked(feats, seg), repeats, device)
    print(
        f"serve[{device}]: wave {W}x{C} rows={W * C} wave_ms={wave_ms:.3f}"
        f" (join_ms={join_ms:.3f} score_ms={score_ms:.3f})"
    )
    out = {
        "flush_first_ms": first_flush_ms,
        "flush_refresh_ms": refresh_ms,
        "wave_ms": wave_ms,
        "join_ms": join_ms,
        "score_ms": score_ms,
        "rows": W * C,
        "edges": stats["edges"],
    }
    if device.type == "cuda":
        cpu_eng = fed("cpu")
        cpu_eng.flush(now=now)
        cpu_aff = cpu_eng.rtt_affinity_pairs(src, dst)
        cpu_scores = MLPScorer(deserialize_params_auto(blob), device="cpu").predict(feats)
        aff_err = float(np.abs(aff - cpu_aff).max())
        score_err = float(np.abs(scores - cpu_scores).max())
        print(
            f"serve: max|aff - cpu|={aff_err:.3g} (tol 1e-5)"
            f" max|score(bf16) - cpu(f32)|={score_err:.3g} (tol 2e-2)"
        )
        check(aff_err <= 1e-5, "affinities differ from the CPU engine")
        check(score_err <= 2e-2, "scores differ from the CPU scorer")
        check(float((aff > 0).mean()) > 0.9, "affinity column mostly missing")
        out.update(aff_err=aff_err, score_err=score_err)
    return out


@dataclass
class _Model:
    """The fields the refresher reads of the manager's ``Model`` message."""

    model_id: str
    type: str
    version: int
    state: str
    updated_at_ns: int
    created_at_ns: int


class _Manager:
    """An in-process shortcut for the manager, for the legs that run in this
    process without gRPC (scheduler, trainer, resume, federation, preheat,
    native): ``CreateModel`` stores a model as the next version of its id,
    active at once (the real manager's activation step is an operator's:
    the server and download legs run the port's ``ManagerServer`` and
    activate each version with ``UpdateModel``), ``ListModels`` lists each
    id at its newest version, ``GetModelWeights`` returns a stored model's
    npz bytes and ``CreateJob`` keeps the job's request. It answers with
    plain records."""

    def __init__(self):
        self.created = {}  # model_id → its newest CreateModel request
        self.versions = {}  # model_id → its newest version
        self.stamps = {}  # model_id → creation order of its newest version
        self.jobs = []  # the CreateJob requests, in order (job id = place + 1)
        self.calls = {}  # RPC name → times called
        self._seq = 0  # creation order: a newer upload is the newer activation
        self._lock = threading.Lock()

    def _called(self, name):
        with self._lock:
            self.calls[name] = self.calls.get(name, 0) + 1

    def CreateModel(self, request, context=None):
        self._called("CreateModel")
        with self._lock:
            mid = request.model_id
            self.created[mid] = request
            self.versions[mid] = self.versions.get(mid, 0) + 1
            self._seq += 1
            self.stamps[mid] = self._seq

    def ListModels(self, request, context=None):
        self._called("ListModels")
        with self._lock:
            rows = [(r, self.versions[m], self.stamps[m]) for m, r in self.created.items()]
        return SimpleNamespace(models=[_Model(r.model_id, r.type, v, "active", n, n) for r, v, n in rows])

    def GetModelWeights(self, request, context=None):
        self._called("GetModelWeights")
        with self._lock:
            known = self.versions.get(request.model_id) == request.version
            req = self.created.get(request.model_id)
        check(known, "unknown model asked for")
        return SimpleNamespace(weights=req.weights)

    def CreateJob(self, request, context=None):
        self._called("CreateJob")
        with self._lock:
            self.jobs.append(request)
            return SimpleNamespace(id=len(self.jobs))


class _Rest:
    """An operator's client of the manager's REST front: JSON in and out
    under a bearer token, each request logged as (method, route, status,
    ms). A status other than 200 fails the leg: no step falls back to the
    database or to gRPC."""

    def __init__(self, addr: str, token: str):
        self.addr, self.token = addr, token
        self.log = []

    def call(self, method: str, path: str, body=None, token=None, route=None, raw=False):
        """``route`` names the request in the log (a path without its ids);
        ``token=""`` sends none → the JSON body (``raw``: the bytes)."""
        import urllib.error
        import urllib.request

        token = self.token if token is None else token
        req = urllib.request.Request(
            f"http://{self.addr}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Authorization": f"Bearer {token}"} if token else {},
        )
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                status, data = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, data = e.code, e.read()
        self.log.append((method, route or path, status, (time.perf_counter() - t0) * 1e3))
        check(status == 200, f"REST {method} {path} answered {status}: {data[:300]!r}")
        return data if raw else json.loads(data)

    def summary(self, label: str) -> dict:
        """Prints and returns the requests' count, total ms and statuses,
        and each route's ms."""
        statuses, routes = {}, {}
        for method, route, status, ms in self.log:
            statuses[status] = statuses.get(status, 0) + 1
            key = f"{method} {route}"
            routes[key] = routes.get(key, 0.0) + ms
        out = {"requests": len(self.log), "ms": sum(ms for *_, ms in self.log), "statuses": statuses,
               "routes_ms": routes}
        print(f"{label}: REST: {out['requests']} requests to the manager's front in {out['ms']:.2f} ms,"
              f" statuses {statuses}; " + ", ".join(f"{k} {v:.2f} ms" for k, v in routes.items()))
        return out


def manager_server(work: Path, kv_port: int = -1):
    """The port's ``ManagerServer`` as shipped, in this process: sqlite and
    the ``fs`` object storage under ``work``, the read-through cache at its
    30 s, the telemetry plane, the REST front and console on a port of
    their own with one operator token of the admin role, ``/metrics`` on
    another, the embedded RESP KV server when ``kv_port >= 0`` (the
    address at ``kv_addr``), and the certificate authority when the
    ``cryptography`` package is there (its absence is printed, never
    skipped in silence) →
    (server, its gRPC address, the operator's channel to it, that
    channel's client of the manager service, manager_pb2, the operator's
    ``_Rest`` client of the REST address); the caller closes the channel."""
    import importlib.util

    from dragonfly2_torch.manager.server import ManagerServer, ManagerServerConfig
    from dragonfly2_torch.rpc import glue, protos

    certs = importlib.util.find_spec("cryptography") is not None
    if not certs:
        print("manager: the cryptography package is missing here; the manager runs with issue_certs=False")
    token = secrets.token_urlsafe(24)
    mgr = ManagerServer(ManagerServerConfig(data_dir=str(work), metrics_port=0, issue_certs=certs,
                                            rest_port=0, rest_tokens={token: "admin"}, kv_port=kv_port))
    addr = mgr.serve()
    check(mgr.rest_addr is not None, "the manager serves no REST front")
    channel = glue.dial(addr)
    return (mgr, addr, channel, glue.ServiceClient(channel, glue.MANAGER_SERVICE), protos.load("manager_pb2"),
            _Rest(mgr.rest_addr, token))


def activate(ops, pb2, model_id: str, version: int) -> None:
    """``UpdateModel(state="active")``, as an operator activates a version."""
    got = ops.UpdateModel(pb2.UpdateModelRequest(model_id=model_id, version=version, state="active"))
    check(got.state == "active" and got.version == version, f"{model_id} v{version} is not active: {got}")


def activate_over_rest(rest: _Rest, model_id: str, version: int) -> None:
    """``PUT /api/v1/models/:model_id/versions/:version/state``, as an
    operator activates a version through the REST front."""
    got = rest.call("PUT", f"/api/v1/models/{model_id}/versions/{version}/state", {"state": "active"},
                    route="/api/v1/models/:model_id/versions/:version/state")
    check(got["state"] == "active" and (got["model_id"], got["version"]) == (model_id, version),
          f"{model_id} v{version} is not active: {got}")


def plane_view(plane, service: str, instance: str) -> dict:
    """What the manager's telemetry plane holds of one reporter: the
    newest cumulative value of each counter and gauge it pushed."""
    with plane._lock:
        rep = plane._reporters.get((service, instance))
        check(rep is not None, f"the telemetry plane holds no {service} {instance}")
        return {"counters": dict(rep.counters_cum), "gauges": dict(rep.gauges)}


class _RecordingEvaluator(MLEvaluator):
    """The ``ml`` evaluator, keeping the last wave's candidate sets."""

    def evaluate_wave(self, children, candidate_sets, total_piece_counts):
        self.last_sets = [list(c) for c in candidate_sets]
        return super().evaluate_wave(children, candidate_sets, total_piece_counts)


class _RecordingService(ScoringService):
    """The scoring service, keeping the last wave's features, host pairs
    and what it handed back: per decision (scores, ranking)."""

    def score_wave(self, features, pairs, counts, budget_s=None):
        out = super().score_wave(features, pairs, counts, budget_s=budget_s)
        self.last = (np.asarray(features, np.float32), list(pairs or ()), out)
        return out


def device_busy(fn) -> "tuple[float, float | None]":
    """One ``fn()`` under ``torch.profiler`` → (its host wall in ms, the
    summed durations of the CUDA kernels and copies it ran, in ms; None
    when the trace holds no device activity)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    return wall_ms, (busy_us / 1e3 if busy_us else None)


def build_swarm(ids, tasks: int, peers: int, rng: np.random.Generator):
    """The scheduler's resource model over the hosts ``ids``: host stats in
    their valid ranges (about 1 host in 50 a seed peer), ``tasks`` image
    layers of ``peers`` peers each on distinct hosts; a quarter of each
    task's peers have succeeded, the rest are running with one succeeded
    parent each → (resource, the running peers)."""
    n = len(ids)
    resource = res.Resource()
    seed_hosts = rng.random(n) < 1 / 50
    for i, hid in enumerate(ids):
        h = res.Host(
            id=hid,
            type=res.HostType.SUPER if seed_hosts[i] else res.HostType.NORMAL,
            hostname=hid,
            ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}",
            port=65000,
            download_port=65002,
        )
        h.cpu.logical_count = h.cpu.physical_count = 32
        h.cpu.percent = float(rng.uniform(0, 100))
        h.cpu.process_percent = float(rng.uniform(0, h.cpu.percent))
        h.memory.total = 64 << 30
        h.memory.used_percent = float(rng.uniform(5, 95))
        h.memory.available = int(h.memory.total * (1 - h.memory.used_percent / 100))
        h.network.tcp_connection_count = int(rng.integers(0, 2000))
        h.network.upload_tcp_connection_count = int(rng.integers(0, 200))
        h.network.location = f"cn|r{rng.integers(4)}|z{rng.integers(8)}|rack{rng.integers(64)}"
        h.network.idc = f"idc-{rng.integers(16)}"
        h.disk.used_percent = float(rng.uniform(5, 95))
        h.disk.inodes_used_percent = float(rng.uniform(1, 60))
        h.upload_count = int(rng.integers(0, 500))
        h.upload_failed_count = int(rng.integers(0, h.upload_count // 10 + 1))
        resource.host_manager.store(h)
    hosts = resource.host_manager
    running = []
    for t in range(tasks):
        task = res.Task(f"layer-{t:02d}", url=f"https://registry.example/v2/app/blobs/sha256:{t:064x}")
        task.content_length = int(rng.lognormal(np.log(48 << 20), 0.8))
        task.total_piece_count = -(-task.content_length // task.piece_length)
        task.fsm.event(res.TASK_EVENT_DOWNLOAD)
        resource.task_manager.store(task)
        done, fed = [], []
        for k, hi in enumerate(rng.choice(n, peers, replace=False)):
            peer = res.Peer(f"peer-{t:02d}-{k:03d}", task, hosts.load(ids[hi]))
            peer.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
            peer.fsm.event(res.PEER_EVENT_DOWNLOAD)
            for cost in rng.lognormal(np.log(40.0), 0.5, rng.integers(2, 9)):
                peer.append_piece_cost(float(cost))
            if k < peers // 4:
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
                peer.finished_pieces = set(range(task.total_piece_count))
                done.append(peer)
            else:
                peer.finished_pieces = set(range(int(rng.integers(0, task.total_piece_count))))
                fed.append(peer)
            resource.peer_manager.store(peer)
        for peer in fed:
            task.add_peer_edge(done[int(rng.integers(len(done)))], peer)
        running += fed
    return resource, running


@contextlib.contextmanager
def gnn_head_like_the_card():
    """Every ``GNNScorer`` predict inside rounds its pair head's matmul
    inputs to bfloat16, as the card's do: a CPU run to hold the card's GNN
    scores against."""
    plain = trainer_serving.predict_edge

    def predict_edge_bf16(model, embeddings, src, dst):
        hs, hd = embeddings[src.long()], embeddings[dst.long()]
        pair = torch.cat([hs, hd, hs * hd], dim=-1)
        return apply_mlp(model.head, pair, compute_dtype=torch.bfloat16)[..., 0]

    trainer_serving.predict_edge = predict_edge_bf16
    try:
        yield
    finally:
        trainer_serving.predict_edge = plain


def gnn_head_band(model, emb, src, dst) -> "tuple[np.ndarray, np.ndarray]":
    """The GNN's pair head over the embedding rows ``src``, ``dst`` of
    ``emb`` as the card runs it (bf16 matmul inputs, float32 sums), computed
    in float64 → (scores, how far the card's may lie from them). A hidden
    unit's 192 products are exact in float32; the card sums them and the
    bias in an order of its own, in any order at most (K + 2)·2^-24·Σ|terms|
    from the exact sum, and its float32 gelu adds a few roundings. Where
    that span holds a bf16 rounding midpoint the unit may round to either
    neighbour, and the score may move by |w_j| times their distance; the
    last layer's float32 sum adds its own bound."""
    u = 2.0**-24

    def bf16(t):
        return t.float().to(torch.bfloat16).double()

    l0, l1 = model.head.layers
    hs, hd = emb[src].float(), emb[dst].float()
    x = bf16(torch.cat([hs, hd, hs * hd], dim=-1))
    w0, b0, w1, b1 = bf16(l0.w), l0.b.double(), bf16(l1.w), l1.b.double()
    z = x @ w0 + b0
    z_err = (w0.shape[0] + 2) * u * (x.abs() @ w0.abs() + b0.abs())
    h = torch.nn.functional.gelu(z, approximate="tanh")
    h_err = 1.2 * z_err + 16 * u * (z.abs() + h.abs())
    hb = bf16(h)
    spread = bf16(h + h_err) - bf16(h - h_err)
    score = hb @ w1 + b1
    allowance = spread @ w1.abs() + (w1.shape[0] + 2) * u * (hb.abs() @ w1.abs() + b1.abs())
    return score[:, 0].numpy(), allowance[:, 0].numpy()


def hold_served_gnn(name, card, cpu, src_ids, dst_ids, scores) -> dict:
    """The card's served GNN scores of (src, dst) host pairs, ``card`` the
    ``GNNScorer`` that served them and ``cpu`` the same model on the same
    graph on the CPU, held in two stages that no bf16 rounding turns by
    chance: the card's node embeddings against the CPU's, then the scores
    against ``gnn_head_band`` over the card's own embedding rows."""
    check(card._node_index == cpu._node_index, f"{name}: the card's GNN embedded another graph")
    emb = card._emb.float().cpu()
    emb_err = float((emb - cpu._emb.float()).abs().max())
    src = torch.tensor([cpu._node_index[h] for h in src_ids])
    dst = torch.tensor([cpu._node_index[h] for h in dst_ids])
    with torch.no_grad():
        want, allowance = gnn_head_band(cpu._model, emb, src, dst)
    gap = np.abs(np.asarray(scores, np.float64) - want)
    out = {
        "emb_err": emb_err, "head_err": float((gap - allowance).max()), "head_gap": float(gap.max()),
        "pairs": len(gap), "pairs_past_head_tol": int((gap > GNN_HEAD_TOL).sum()),
        "allowance_max": float(allowance.max()),
    }
    print(
        f"{name}: the served GNN in two stages: max|card - cpu| of the node embeddings {emb_err:.3g}"
        f" (tol {GNN_EMB_TOL:g}); of {len(gap)} scores against the CPU's bf16 head over the card's"
        f" embeddings max {out['head_gap']:.3g}, {out['pairs_past_head_tol']} past {GNN_HEAD_TOL:g},"
        f" each within its units' rounding band (the widest {out['allowance_max']:.3g}) to"
        f" {out['head_err']:.3g} (tol {GNN_HEAD_TOL:g})"
    )
    check(emb_err <= GNN_EMB_TOL, f"{name}: the card's GNN node embeddings differ from the CPU's")
    check(out["head_err"] <= GNN_HEAD_TOL, f"{name}: served GNN scores lie outside their rounding band")
    return out


def gnn_swap(manager, model_id, topology, service, dev) -> dict:
    """The GNN's swap-time work, timed apart from the refresher's install:
    the probe-graph export, the graph build and the embed over it on
    ``dev``; then the served GNN scored on every exported edge against the
    edge's RTT (it must beat the mean predictor: the node embedding table
    it was trained with lines up with the live graph's hosts)."""
    params = deserialize_params_auto(manager.created[model_id].weights)
    t0 = time.perf_counter()
    records = topology.export_records()
    t1 = time.perf_counter()
    graph = build_probe_graph(records_to_columns(records))
    t2 = time.perf_counter()
    GNNScorer(params, graph, device=dev)
    sync(dev)
    t3 = time.perf_counter()
    served = service._served[0]._scorer
    ids = graph.node_ids
    pred = served.predict_rtt_log_ms([ids[i] for i in graph.edge_src], [ids[i] for i in graph.edge_dst])
    y = graph.edge_rtt_log_ms
    out = {
        "gnn_export_ms": (t1 - t0) * 1e3, "gnn_graph_ms": (t2 - t1) * 1e3,
        "gnn_embed_ms": (t3 - t2) * 1e3, "gnn_nodes": graph.num_nodes,
        "gnn_edges": len(y), "gnn_served_mse": float(np.mean((pred - y) ** 2)),
        "gnn_served_mean_predictor_mse": mean_mse(y),
    }
    print(
        f"scheduler[{dev}]: gnn swap over {out['gnn_nodes']} hosts / {out['gnn_edges']} edges:"
        f" export_ms={out['gnn_export_ms']:.1f} graph_ms={out['gnn_graph_ms']:.1f}"
        f" embed_ms={out['gnn_embed_ms']:.1f}; served mse on the exported edges"
        f" {out['gnn_served_mse']:.5f} (mean predictor {out['gnn_served_mean_predictor_mse']:.5f})"
    )
    check(np.isfinite(pred).all() and out["gnn_served_mse"] < out["gnn_served_mean_predictor_mse"],
          "the served GNN does not beat the mean predictor on the live graph's edges")
    return out


def scheduler_leg(
    device, hosts=10_000, probes=16, tasks=40, peers=256, wave_size=256, waves=20, warmup=2,
    seed=0, manager=None,
) -> dict:
    """The scheduler's ``ml`` decision path on ``device``: the active MLP of
    ``manager`` (by default the in-process shortcut holding a seeded random
    one) installed by the refresher, then ``warmup`` + ``waves`` waves of
    ``wave_size`` running children through
    ``Scheduling.find_candidate_parents_wave``. Each checked wave must be
    scored by the service (rung ``serving``, one service wave, no
    demotion, no fallback) and rank every decision by ``rank_order`` of
    its scores; on the card the same waves then run on the CPU and must
    give the same candidate sets and scores within ``SCORE_TOL``."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    resource, running = build_swarm(ids, tasks, peers, rng)
    children = [
        [running[i] for i in rng.choice(len(running), wave_size, replace=False)]
        for _ in range(warmup + waves)
    ]
    if manager is None:
        manager = _Manager()
        blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
        manager.CreateModel(PlainRequests().create_model("mlp-smoke", "mlp", "", "smoke", blob, {}))

    gnn_scorers = {}  # device type → the GNNScorer its waves were served by

    def run(dev):
        """The leg's waves on ``dev`` → per checked wave (candidate ids per
        decision, features, per-decision (scores, ranking), host pairs), and
        times."""
        eng = fed(dev)
        eng.flush(now=PROBED_AT)
        service = _RecordingService()
        service.start()
        try:
            evaluator = _RecordingEvaluator(topology=eng, serving=service)
            topology = NetworkTopology(KVStore(), resource.host_manager, engine=eng)
            refresher = ModelRefresher(
                manager, evaluator, serving=service, networktopology=topology, device=dev,
                requests=PlainRequests(),
            )
            t0 = time.perf_counter()
            check(refresher.refresh_once(), "the refresher installed no model")
            sync(dev)
            install_ms = (time.perf_counter() - t0) * 1e3
            # the newest model of each type is the active one
            latest = {m.type: m.model_id for m in manager.ListModels(None).models}
            served_kind = "gnn" if "gnn" in latest else "mlp"
            check(refresher.loaded_version == (latest["mlp"], 1), "another MLP installed")
            check(evaluator._model is not None and evaluator._model.device.type == dev.type,
                  "the MLP is not installed on the leg's device")
            # the refresher's installs are best-effort: a model that failed
            # to install must fail here, never pass on a lower rung
            check(service.model_kind() == served_kind,
                  f"serving {service.model_kind()!r}, not the {served_kind!r} the manager activated")
            extra = {}
            if "gnn" in latest:
                check(refresher.loaded_gnn_version == (latest["gnn"], 1), "the GNN is not installed")
                extra.update(gnn_swap(manager, latest["gnn"], topology, service, dev))
                gnn_scorers[dev.type] = service._served[0]._scorer
            if "gru" in latest:
                check(refresher.loaded_gru_version == (latest["gru"], 1), "the GRU is not installed")
                check(isinstance(evaluator._gru, GRUScorer) and evaluator._gru.device.type == dev.type,
                      "the GRU is not installed on the leg's device")
            sched = Scheduling(evaluator)
            fallbacks = scheduler_metrics.SERVING_FALLBACK_TOTAL
            phases = (wave.PH_WAVE_PACK, wave.PH_WAVE_SCORE)
            out, walls, rows = [], [], []
            for w, kids in enumerate(children):
                if w == warmup:
                    phase0 = [(ph.count, ph.total_s) for ph in phases]
                    batches0 = service.batches
                before = (service.waves, sum(fallbacks.labels(r).value for r in ("mlp", "base")))
                t_start = time.time_ns()
                random.seed(seed * 1000 + w)
                t0 = time.perf_counter()
                found = sched.find_candidate_parents_wave(kids)
                sync(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
                if w < warmup:
                    print(f"scheduler[{dev}]: warm-up wave {w}: {wall_ms:.1f} ms, rung {evaluator._rung!r}")
                    continue
                walls.append(wall_ms)
                feats, pairs, scored = service.last
                sets = evaluator.last_sets
                last = [
                    e for e in flight.snapshot(["scheduler"])["scheduler"]
                    if e["type"] == "scheduler.wave_evaluated" and e["ts_ns"] >= t_start
                ]
                name = f"scheduler[{dev}] wave {w}"
                check(evaluator._rung == "serving", f"{name}: rung {evaluator._rung!r}, not serving")
                check(service.waves == before[0] + 1, f"{name}: the service scored no wave")
                check(len(last) == 1 and last[0]["demoted"] == 0, f"{name}: demoted decisions {last}")
                check(
                    sum(fallbacks.labels(r).value for r in ("mlp", "base")) == before[1],
                    f"{name}: a serving fallback was counted",
                )
                check(all(ok for _, ok in found) and len(sets) == len(kids), f"{name}: a child found no parent")
                check(feats.shape == (sum(map(len, sets)), MLP_FEATURE_DIM), f"{name}: feature shape")
                for (parents, _), cands, (scores, ranking) in zip(found, sets, scored):
                    check(np.isfinite(scores).all() and len(scores) == len(cands), f"{name}: scores")
                    check(
                        np.array_equal(ranking, wave.rank_order(scores, np.zeros(len(scores)))),
                        f"{name}: a ranking differs from rank_order of its scores",
                    )
                    check(
                        [p.id for p in parents] == [cands[int(k)].id for k in ranking[:4]],
                        f"{name}: the decision is not its ranking's head",
                    )
                rows.append(feats.shape[0])
                out.append(([[p.id for p in c] for c in sets], feats, scored, pairs))
            if "gru" in latest:
                # the GRU branch of is_bad_node ran: it caches one verdict
                # per candidate it scored, and only on success
                verdicts = evaluator._gru_verdicts
                check(len(verdicts) > 0, "is_bad_node never took the GRU branch")
                extra.update(gru_verdicts=len(verdicts),
                             gru_bad=sum(1 for _, bad in verdicts.values() if bad))
            times = {
                **extra,
                "kind": served_kind,
                "install_ms": install_ms,
                "rows_per_wave": statistics.mean(rows),
                "service_batches": service.batches - batches0,
                "schedule_wave_ms": statistics.median(walls),
                "schedule_wave_mean_ms": statistics.mean(walls),
            }
            for key, ph, (n0, s0) in zip(("pack_ms", "score_ms"), phases, phase0):
                times[key] = (ph.total_s - s0) / (ph.count - n0) * 1e3
            if dev.type == "cuda":  # one more wave, traced, outside the times above
                random.seed(seed * 1000 + warmup)
                try:  # the trace is a reading aid; the checked waves stand
                    traced = device_busy(lambda: sched.find_candidate_parents_wave(children[warmup]))
                except Exception as exc:
                    traced = (None, None)
                    print(f"scheduler[{dev}]: no device trace: {exc}")
                wall_ms, busy_ms = traced
                if busy_ms is not None:
                    times.update(traced_wave_ms=wall_ms, device_busy_ms=busy_ms,
                                 device_idle_share=1 - busy_ms / wall_ms)
                    print(
                        f"scheduler[{dev}]: traced wave: {wall_ms:.2f} ms wall, device busy"
                        f" {busy_ms:.3f} ms (idle share {times['device_idle_share']:.4f})"
                    )
            return out, times
        finally:
            service.stop()

    got, times = run(device)
    decisions = waves * wave_size
    mean_cands = sum(f.shape[0] for _, f, _, _ in got) / decisions
    times["filter_ms"] = times["schedule_wave_mean_ms"] - times["pack_ms"] - times["score_ms"]
    print(
        f"scheduler[{device}]: {len(ids)} hosts, {tasks} tasks x {peers} peers,"
        f" {waves} waves of {wave_size}: rows/wave={times['rows_per_wave']:.1f}"
        f" (mean {mean_cands:.2f} candidates per decision) service_batches={times['service_batches']}"
        f" install_ms={times['install_ms']:.1f} schedule_wave_ms={times['schedule_wave_ms']:.2f}"
        f" (mean {times['schedule_wave_mean_ms']:.2f}: pack_ms={times['pack_ms']:.2f}"
        f" score_ms={times['score_ms']:.2f} filter_ms={times['filter_ms']:.2f})"
    )
    if mean_cands < 8:
        print(f"scheduler[{device}]: only {mean_cands:.2f} candidates per decision (fewer than 8)")
    check(mean_cands >= 8, "fewer than 8 candidates per decision")
    out = {**times, "decisions": decisions, "mean_candidates": mean_cands}
    if device.type == "cuda":
        # a GNN on the card is held to a CPU run with its pair head in bf16
        with gnn_head_like_the_card() if times["kind"] == "gnn" else contextlib.nullcontext():
            want, _ = run(torch.device("cpu"))
        score_err = rtt_err = 0.0
        for w, ((sets, feats, scored, _), (cpu_sets, cpu_feats, cpu_scored, _)) in enumerate(zip(got, want)):
            check(sets == cpu_sets, f"wave {w}: candidate sets differ from the CPU run")
            check(np.array_equal(feats[:, :-1], cpu_feats[:, :-1]), f"wave {w}: host features differ")
            rtt_err = max(rtt_err, float(np.abs(feats[:, -1] - cpu_feats[:, -1]).max()))
            for (s, _), (cs, _) in zip(scored, cpu_scored):
                score_err = max(score_err, float(np.abs(s - cs).max()))
        tol = GNN_SCORE_TOL if times["kind"] == "gnn" else SCORE_TOL
        print(
            f"scheduler: candidate sets equal the CPU run's in {waves} waves;"
            f" max|rtt_affinity - cpu|={rtt_err:.3g} (tol 1e-5)"
            f" max|{times['kind']} score(bf16) - cpu({'bf16 head' if times['kind'] == 'gnn' else 'f32'})|"
            f"={score_err:.3g} (tol {tol:g})"
        )
        check(rtt_err <= 1e-5, "rtt_affinity differs from the CPU engine")
        if times["kind"] == "gnn":
            pairs = [p for _, _, _, wave_pairs in got for p in wave_pairs]
            scores = np.concatenate([s for _, _, scored, _ in got for s, _ in scored])
            out["gnn_stages"] = hold_served_gnn(
                "scheduler", gnn_scorers["cuda"], gnn_scorers["cpu"],
                [a for a, _ in pairs], [b for _, b in pairs], scores,
            )
        check(score_err <= tol, "scores differ from the CPU run")
        out.update(rtt_err=rtt_err, score_err=score_err)
    return out



def topology_records(ids, peers, rtts, rng: np.random.Generator) -> list:
    """The probe graph as the scheduler's topology snapshotter writes it:
    each snapshot one ``NetworkTopologyRecord`` per host with ≤ 5 of its
    probed peers (``records.MAX_DEST_HOSTS``), snapshot after snapshot, so
    the first snapshot lists hosts and peers in the order the engine's own
    export does (the graph's node order, which the GNN's per-node
    embedding table follows); host stats seeded from ``rng``, about 1 host
    in 50 a seed peer."""
    n = len(ids)
    seeds = rng.random(n) < 1 / 50
    tcp = rng.integers(10, 2000, n)
    utcp = rng.integers(0, 500, n)

    def host(cls, i, **kw):
        return cls(
            id=ids[i], type="super" if seeds[i] else "normal", hostname=ids[i],
            ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", port=65000,
            network=R.Network(
                tcp_connection_count=int(tcp[i]), upload_tcp_connection_count=int(utcp[i]),
                idc=f"idc-{i % 16}",
            ),
            **kw,
        )

    out = []
    for c in range(0, peers.shape[1], R.MAX_DEST_HOSTS):
        for i in range(n):
            dests = [
                host(R.DestHost, int(j), probes=R.ProbesRecord(average_rtt=int(rtt)))
                for j, rtt in zip(peers[i, c : c + R.MAX_DEST_HOSTS], rtts[i, c : c + R.MAX_DEST_HOSTS])
            ]
            out.append(R.NetworkTopologyRecord(
                id=f"nt-{i}-{c // R.MAX_DEST_HOSTS}", host=host(R.SrcHost, i), dest_hosts=dests,
            ))
    return out


def encode_blocks(encode, recs) -> bytes:
    """``recs`` as consecutive blocks of ``wire.BLOCK_RECORDS``, the size the
    scheduler's sink flushes."""
    step = wire.BLOCK_RECORDS
    return b"".join(encode(recs[i : i + step]) for i in range(0, len(recs), step))


def holdout_labels(blocks, eval_every: int, cap: int, total_blocks: int) -> np.ndarray:
    """The labels ``stream_train_mlp`` holds out and collects from a stream
    of ``total_blocks`` blocks that repeats ``blocks`` (decoded shards in
    stream order): every shard's ``ingest.holdout_mask`` pairs, appended
    until ``cap`` pairs are collected, as the fit collects them."""
    out, got = [], 0
    for b in range(total_blocks):
        if got >= cap:
            break
        feats, labels = blocks[b % len(blocks)]
        mask = holdout_mask(feats, labels, eval_every)
        if mask.any():
            out.append(labels[mask])
            got += int(mask.sum())
    return np.concatenate(out).astype(np.float32)


def mean_mse(y: np.ndarray) -> float:
    """MSE of the mean predictor (every prediction the labels' mean)."""
    return float(np.mean((y - y.mean()) ** 2))


def trainer_leg(
    device, files=UPLOAD_FILES, file_mib=FILE_MIB, hosts=10_000, probes=16, mlp_epochs=3,
    gnn_epochs=60, check_blocks=64, window_superbatches=20, seed=0,
    serve=dict(tasks=40, peers=256, wave_size=256, waves=3, warmup=1),
    streaming_threshold_bytes=TrainingConfig.streaming_threshold_bytes,
    group_records=2000, mlp_batch=8192, gnn_batch=2048, gru_max_sequences=GRU_MAX_SEQUENCES,
    manager=None,
) -> dict:
    """The trainer's fit path on ``device``: one upload round — ``files`` ×
    ``file_mib`` MiB of binary train blocks (2,000 seeded download records
    replicated, as ``synth.synthesize_dataset_binary`` does) and the serve
    leg's probe graph as topology blocks — fed through
    ``TrainerService.Train`` in the announcer's chunks; ``Training`` built
    as the trainer server builds it from its defaults (MLP streamed,
    2 passes, 1 worker, k = 1; GNN 60 epochs; GRU on, batch 128, 10
    epochs), with one cut: the GRU keeps the newest ``gru_max_sequences``
    (a rehearsal at a reduced size also lowers the 64 MiB streaming
    threshold, the group and the batches). All three uploads must reach
    the in-process manager shortcut and beat the mean predictor on their
    holdout; then the refresher installs the three trained models and scheduler
    waves run on them (``scheduler_leg``): the GNN in the serving slot,
    the GRU behind bad-node detection. On the card, a reduced streamed MLP
    fit and a reduced GRU fit are held against the same fits on the CPU,
    and ~20 superbatches are traced for the device's idle share. The
    uploads land in ``manager`` (a new in-process shortcut when None)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    shutil.rmtree(TRAINER_WORK, ignore_errors=True)
    TRAINER_WORK.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        group = encode_blocks(
            wire.encode_train_block, synth.make_download_records(group_records, seed=seed)
        )
        group_path = TRAINER_WORK / "group.dfb"
        group_path.write_bytes(group)
        group_pairs = wire.read_train_pairs(group_path)
        reps = max(1, (file_mib << 20) // len(group))
        ids, _, peers, rtts = probe_graph(hosts, probes, rng)
        topo_path = TRAINER_WORK / "topology.dfb"
        topo_path.write_bytes(encode_blocks(wire.encode_topology_block, topology_records(ids, peers, rtts, rng)))
        records = files * reps * group_pairs.num_downloads
        print(
            f"trainer[{device}]: upload round: {files} files x {reps} x {len(group)} B ="
            f" {files * reps * len(group) / 2**20:.1f} MiB of train blocks ({records} download"
            f" records, {files * reps * len(group_pairs.labels)} pairs); topology"
            f" {topo_path.stat().st_size / 2**20:.1f} MiB ({hosts} hosts x {probes} probes);"
            f" made in {time.perf_counter() - t0:.1f}s"
        )

        messages = PlainMessages()

        def chunks(kind, data):
            for off in range(0, len(data), UPLOAD_CHUNK):
                yield messages.train_request(TRAINER_IP, TRAINER_HOST, kind, data[off : off + UPLOAD_CHUNK])

        def requests():
            for _ in range(files):
                yield from chunks("train_mlp_binary", group * reps)
            yield from chunks("train_gnn_binary", topo_path.read_bytes())

        manager = manager if manager is not None else _Manager()
        # fit snapshots every epoch, as a trainer run with a checkpoint_dir
        # takes them (the streamed MLP fit and the GRU fit take none)
        snapshots = TRAINER_WORK / "snapshots"
        # as dragonfly2_tpu/trainer/server.py:86-113 builds it from the
        # server's defaults, plus the GRU's one cut
        config = TrainingConfig(
            mlp=FitConfig(epochs=mlp_epochs, batch_size=mlp_batch),
            gnn=GNNFitConfig(epochs=gnn_epochs, batch_size=gnn_batch),
            min_download_records=1,
            min_topology_records=1,
            gru=True,
            gru_min_sequences=8,
            incremental=False,
            clear_after_train=True,
            streaming=True,
            streaming_workers=1,
            auto_mesh=True,
            profile_dir="",
            checkpoint_dir=str(snapshots),
            streaming_threshold_bytes=streaming_threshold_bytes,
            gru_max_sequences=gru_max_sequences,
        )
        storage = TrainerStorage(TRAINER_WORK / "storage")
        training = Training(storage, ManagerUploader(manager, PlainRequests()), config, device=device)
        service = TrainerService(storage, training, synchronous=True, messages=messages)
        fit_walls = {m: (M_T.FIT_DURATION.labels(m).total, M_T.FIT_TOTAL.labels(m, "success").value)
                     for m in ("mlp", "gnn", "gru")}
        since = time.time_ns()
        t0 = time.perf_counter()
        with recorded_snapshots() as saves:
            service.Train(requests(), None)
            sync(device)
        round_s = time.perf_counter() - t0
        gnn_saves = [ms for d, _, ms in saves if d.name.startswith("gnn-")]
        check(len(gnn_saves) == gnn_epochs and len(saves) == gnn_epochs,
              f"the round took {len(saves)} snapshots, {len(gnn_saves)} of the GNN fit ({gnn_epochs} epochs)")
        check(not snapshots.exists() or not any(snapshots.iterdir()),
              f"snapshot directories are left after the round: {sorted(snapshots.iterdir())}")
        events = [e for e in flight.snapshot(["trainer"])["trainer"] if e["ts_ns"] >= since]
        rounds = [e for e in events if e["type"] == "trainer.round"]
        check(len(rounds) == 1 and rounds[0]["ok"], f"the training round failed: {rounds}")
        done = [e for e in events if e["type"] == "trainer.stream_done"]
        check(len(done) == 1, "the MLP leg did not take the streamed fit")
        split = done[0]
        check(device.type == "cpu" or split["h2d_s"] > 0, "the streamed fit copied nothing to the card")
        for m, (total0, ok0) in fit_walls.items():
            check(M_T.FIT_TOTAL.labels(m, "success").value == ok0 + 1, f"no successful {m} fit")
            fit_walls[m] = M_T.FIT_DURATION.labels(m).total - total0
        mlp_up = manager.created[mlp_model_id_v1(TRAINER_IP, TRAINER_HOST)]
        gnn_up = manager.created[gnn_model_id_v1(TRAINER_IP, TRAINER_HOST)]
        gru_up = manager.created[gru_model_id_v1(TRAINER_IP, TRAINER_HOST)]
        check((mlp_up.type, gnn_up.type, gru_up.type) == ("mlp", "gnn", "gru"), "uploads of the wrong type")

        # mean predictors on the same holdouts
        cap = 16 * config.mlp.batch_size  # stream_train_mlp's eval_max_batches
        eval_every = max(2, round(1.0 / config.mlp.eval_fraction))
        blocks = [(f, l) for f, l, _ in wire.stream_train_pairs(group_path, half=True)]
        y_mlp = holdout_labels(blocks, eval_every, cap, files * reps * len(blocks) * config.streaming_passes)
        graph = build_probe_graph(wire.read_columns(topo_path), max_degree=config.gnn_max_degree)
        train_idx, eval_idx = _split_eval(len(graph.edge_src), config.gnn.eval_fraction, config.gnn.seed)
        gnn_steps = _batch_steps(len(train_idx), config.gnn.batch_size)[0] * config.gnn.epochs
        # the GRU's holdout: the round's newest gru_max_sequences (the
        # upload repeats the group's sequences), split as train_gru splits
        group_seqs = list(wire.stream_gru_sequences(group_path))
        gru_labels = np.concatenate([q.labels for q in group_seqs])
        gru_total = files * reps * len(gru_labels)
        gru_n = min(gru_total, config.gru_max_sequences)
        gru_kept = np.tile(gru_labels, -(-gru_n // len(gru_labels)))[-gru_n:]
        gru_train, gru_eval = _split_eval(gru_n, config.gru_config.eval_fraction, config.gru_config.seed)
        gru_steps = _batch_steps(len(gru_train), config.gru_config.batch_size)[0] * config.gru_config.epochs
        mlp_ev, gnn_ev, gru_ev = mlp_up.evaluation, gnn_up.evaluation, gru_up.evaluation
        out = {
            "round_s": round_s,
            "snapshots": {"count": len(gnn_saves), "ms_mean": float(np.mean(gnn_saves)),
                          "ms_max": max(gnn_saves), "ms_total": float(np.sum(gnn_saves))},
            "download_mib": files * reps * len(group) / 2**20,
            "mlp": {
                "fit_wall_s": fit_walls["mlp"], "records": split["records"],
                "records_per_s": split["records"] / split["wall_s"], "steps": split["steps"],
                "pairs": split["pairs"], "mse": mlp_ev.mse, "mae": mlp_ev.mae,
                "mean_predictor_mse": mean_mse(y_mlp), "holdout_pairs": len(y_mlp),
                **{k: split[k] for k in ("wall_s", "decode_wait_s", "buffer_wait_s", "h2d_s",
                                         "h2d_overlap_s", "step_s", "read_s", "cast_s", "enqueue_s")},
            },
            "gnn": {
                "fit_wall_s": fit_walls["gnn"], "records": graph.num_records,
                "records_per_s": graph.num_records / fit_walls["gnn"], "steps": gnn_steps,
                "edges": len(graph.edge_src), "nodes": graph.num_nodes, "mse": gnn_ev.mse,
                "mae": gnn_ev.mae, "precision": gnn_ev.precision, "recall": gnn_ev.recall,
                "f1": gnn_ev.f1,
                "mean_predictor_mse": mean_mse(graph.edge_rtt_log_ms[eval_idx]),
            },
            "gru": {
                "fit_wall_s": fit_walls["gru"], "sequences": gru_n, "round_sequences": gru_total,
                "steps": gru_steps, "ms_per_step": fit_walls["gru"] / gru_steps * 1e3,
                "mse": gru_ev.mse, "mae": gru_ev.mae,
                "mean_predictor_mse": mean_mse(gru_kept[gru_eval]), "holdout": len(gru_eval),
            },
        }
        m, g, q = out["mlp"], out["gnn"], out["gru"]
        sn = out["snapshots"]
        print(
            f"trainer[{device}]: round_s={round_s:.1f} with the GNN's snapshots (before snapshots:"
            f" {TRAINER_ROUND_BEFORE_SNAPSHOTS_S} s, NVIDIA H100 80GB HBM3, 700.00 W); {sn['count']} GNN"
            f" snapshots, {sn['ms_mean']:.2f} ms an epoch (max {sn['ms_max']:.2f}, {sn['ms_total']:.1f} ms in"
            f" all); every snapshot directory gone after the round"
        )
        print(
            f"trainer[{device}]: Train stream → fits → CreateModel in {round_s:.1f}s;"
            f" mlp: fit_wall_s={m['fit_wall_s']:.2f} (stream wall {m['wall_s']:.2f}s)"
            f" records/s={m['records_per_s']:.0f} steps={m['steps']} pairs={m['pairs']}"
            f" holdout mse={m['mse']:.5f} mae={m['mae']:.5f} (mean predictor mse"
            f" {m['mean_predictor_mse']:.5f} on {m['holdout_pairs']} pairs)"
        )
        print(
            f"trainer[{device}]: mlp split: " + " ".join(
                f"{k}={m[k]:.3f}" for k in ("decode_wait_s", "buffer_wait_s", "h2d_s",
                                             "h2d_overlap_s", "step_s", "read_s", "cast_s", "enqueue_s"))
        )
        print(
            f"trainer[{device}]: gnn: fit_wall_s={g['fit_wall_s']:.2f} records/s={g['records_per_s']:.0f}"
            f" ({g['records']} topology records) steps={g['steps']} edges={g['edges']} nodes={g['nodes']}"
            f" holdout mse={g['mse']:.5f} mae={g['mae']:.5f} precision={g['precision']:.4f}"
            f" recall={g['recall']:.4f} f1={g['f1']:.4f} (mean predictor mse {g['mean_predictor_mse']:.5f})"
        )
        print(
            f"trainer[{device}]: gru: fit_wall_s={q['fit_wall_s']:.2f} ({q['sequences']} of the round's"
            f" {q['round_sequences']} sequences, the newest kept) steps={q['steps']}"
            f" ({q['ms_per_step']:.2f} ms a step, the fit's wall over its steps, beside the other legs)"
            f" holdout mse={q['mse']:.5f} mae={q['mae']:.5f} (mean predictor mse"
            f" {q['mean_predictor_mse']:.5f} on {q['holdout']} sequences)"
        )
        for name, leg in out.items():
            if name in ("mlp", "gnn", "gru"):
                check(np.isfinite(leg["mse"]) and leg["mse"] < leg["mean_predictor_mse"],
                      f"the {name} fit does not beat the mean predictor on its holdout")

        out["serve"] = scheduler_leg(device, hosts=hosts, probes=probes, seed=seed, manager=manager, **serve)

        if device.type == "cuda":
            out["card_vs_cpu"] = card_vs_cpu(group, len(blocks), check_blocks, seed)
            out["gru_card_vs_cpu"] = gru_card_vs_cpu(group_seqs, GRU_CHECK_SEQUENCES, config.gru_config, seed)
            window = TRAINER_WORK / "window.dfb"
            per_group = len(group_pairs.labels) * (1 - 1 / eval_every)
            window.write_bytes(group * int(np.ceil(window_superbatches * mlp_batch / per_group)))
            fits = []
            wall_ms, busy_ms = device_busy(lambda: fits.append(stream_train_mlp(
                window, batch_size=mlp_batch, hidden_dims=config.mlp.hidden_dims, device=device)[1]))
            if busy_ms is not None:
                out["window"] = {"superbatches": fits[0].steps, "wall_ms": wall_ms,
                                 "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms}
                print(
                    f"trainer[{device}]: traced window of {fits[0].steps} superbatches: {wall_ms:.1f} ms"
                    f" wall, device busy {busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.4f})"
                )
        return out
    finally:
        shutil.rmtree(TRAINER_WORK, ignore_errors=True)


def card_vs_cpu(group: bytes, per_group: int, blocks: int, seed: int) -> dict:
    """A reduced streamed fit (``blocks`` train blocks of ``group``, which
    holds ``per_group``; one init, float32 staging, 1 worker, 2 passes) on
    the card against the same fit on the CPU: every step's loss and the
    holdout mse within ``FIT_TOL``."""
    path = TRAINER_WORK / "check.dfb"
    path.write_bytes(group * max(1, blocks // per_group))
    init = module_tree(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
    kw = dict(passes=2, batch_size=1024, hidden_dims=tuple(MLP_DIMS[1:-1]), workers=1,
              transfer_dtype=np.float32, init=init)
    _, card = stream_train_mlp(path, device="cuda", **kw)
    _, cpu = stream_train_mlp(path, device="cpu", **kw)
    check((card.steps, card.pairs, card.eval_pairs) == (cpu.steps, cpu.pairs, cpu.eval_pairs),
          "the card's fit saw other pairs than the CPU's")
    a, b = np.asarray(card.losses), np.asarray(cpu.losses)
    loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
    mse_err = abs(card.metrics["mse"] - cpu.metrics["mse"]) / cpu.metrics["mse"]
    print(
        f"trainer: card vs CPU, {card.steps} steps of 1024 from one init: max rel |loss - cpu|"
        f"={loss_err:.3g} holdout mse {card.metrics['mse']:.5f} vs {cpu.metrics['mse']:.5f}"
        f" (rel {mse_err:.3g}; tol {FIT_TOL:g} each)"
    )
    check(loss_err <= FIT_TOL and mse_err <= FIT_TOL, "the card's fit differs from the CPU's")
    return {"steps": card.steps, "loss_rel_err": loss_err, "mse_rel_err": mse_err}


def gru_card_vs_cpu(group_seqs, n: int, fit: FitConfig, seed: int) -> dict:
    """A reduced GRU fit (the first ``n`` sequences of the upload group,
    the round's GRU config but 2 epochs, one init) on the card against the
    same fit on the CPU: each epoch's loss and the holdout mse within
    ``GRU_FIT_TOL``; the card's fit alone is timed for its ms per step."""
    seqs = np.concatenate([q.sequences for q in group_seqs])
    reps = -(-n // len(seqs))
    x = np.tile(seqs, (reps, 1, 1))[:n]
    y = np.tile(np.concatenate([q.labels for q in group_seqs]), reps)[:n]
    ln = np.tile(np.concatenate([q.lengths for q in group_seqs]), reps)[:n]
    init = module_tree(init_gru(torch.Generator().manual_seed(seed), GRU_FEATURE_DIM, fit.hidden_dims[0]))
    cfg = FitConfig(hidden_dims=fit.hidden_dims, batch_size=fit.batch_size, epochs=2, seed=fit.seed, init=init)
    steps = _batch_steps(len(_split_eval(n, cfg.eval_fraction, cfg.seed)[0]), cfg.batch_size)[0] * cfg.epochs
    train_gru(x, y, lengths=ln, config=FitConfig(hidden_dims=fit.hidden_dims, batch_size=fit.batch_size,
                                                 epochs=1, init=init), device="cuda")  # warm-up
    sync(torch.device("cuda"))
    t0 = time.perf_counter()
    card = train_gru(x, y, lengths=ln, config=cfg, device="cuda")
    sync(torch.device("cuda"))
    wall = time.perf_counter() - t0
    cpu = train_gru(x, y, lengths=ln, config=cfg, device="cpu")
    a, b = np.asarray(card.history), np.asarray(cpu.history)
    loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
    mse_err = abs(card.metrics["mse"] - cpu.metrics["mse"]) / cpu.metrics["mse"]
    print(
        f"trainer: gru card vs CPU, {steps} steps of {cfg.batch_size} from one init: max rel"
        f" |loss - cpu|={loss_err:.3g} holdout mse {card.metrics['mse']:.5f} vs {cpu.metrics['mse']:.5f}"
        f" (rel {mse_err:.3g}; tol {GRU_FIT_TOL:g} each); the card's fit alone {wall:.2f}s,"
        f" {wall / steps * 1e3:.2f} ms a step"
    )
    check(loss_err <= GRU_FIT_TOL and mse_err <= GRU_FIT_TOL, "the card's GRU fit differs from the CPU's")
    return {"steps": steps, "loss_rel_err": loss_err, "mse_rel_err": mse_err, "wall_s": wall,
            "ms_per_step": wall / steps * 1e3}


@contextlib.contextmanager
def recorded_snapshots(on_save=None):
    """Every ``FitCheckpointer`` a fit opens inside the block records its
    saves → the list of (directory, epoch, ms a save took: the copy to the
    host and the write); ``on_save(epoch, state)`` runs after each save."""
    from dragonfly2_torch.trainer import checkpoint

    base = checkpoint.FitCheckpointer
    saves = []

    class Recording(base):
        def save(self, epoch, state):
            t0 = time.perf_counter()
            super().save(epoch, state)
            saves.append((self._dir, epoch, (time.perf_counter() - t0) * 1e3))
            if on_save is not None:
                on_save(epoch, state)

    checkpoint.FitCheckpointer = Recording
    try:
        yield saves
    finally:
        checkpoint.FitCheckpointer = base


def state_digest(tree) -> str:
    """sha256 over a fit state's tensors (dtype, shape, bytes, on the host)
    and scalars, keys in sorted order: two states with one digest are equal
    bit for bit."""
    h = hashlib.sha256()

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                h.update(str(k).encode())
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            t = node.detach().to("cpu").contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(node).encode())

    walk(tree)
    return h.hexdigest()


def max_abs_diff(a: torch.nn.Module, b: torch.nn.Module) -> float:
    """max over the parameters of max|a - b|."""
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].float() - sb[k].float()).abs().max()) for k in sa)


RESUME_WORK = Path(__file__).resolve().parent / "build" / "resume"
RESUME_FAULTS = "trainer.fit_step=abort#2"  # SIGKILL as epoch 2 starts


def _resume_fit(kind: str, data, directory, config: dict, device):
    """One of the resume phase's fits: ``train_gnn`` on a probe graph or
    ``train_mlp`` on (features, labels), with snapshots under
    ``directory`` when one is given."""
    from dragonfly2_torch.trainer.train import train_gnn, train_mlp

    cfg = (GNNFitConfig if kind == "gnn" else FitConfig)(
        **config, checkpoint_dir=str(directory) if directory else None
    )
    if kind == "gnn":
        return train_gnn(data, config=cfg, device=device)
    return train_mlp(*data, config=cfg, device=device)


def _resume_child(conn, kind, data, directory, config, device, threads):
    """A spawned process's fit under ``RESUME_FAULTS`` (armed from its
    environment at import), on the parent's count of intra-op threads (a
    CPU fit's sums follow it): each save's epoch and state digest go to
    ``conn`` before the fault kills the process."""
    torch.set_num_threads(threads)
    with recorded_snapshots(on_save=lambda epoch, state: conn.send((epoch, state_digest(state)))):
        _resume_fit(kind, data, directory, config, device)
    conn.send(("survived", None))


def resume_phase(device, hosts=10_000, probes=16, epochs=4, group_records=2000, mlp_batch=256, seed=0) -> dict:
    """The crash drill of the trainer's fits on ``device``: a spawned
    process runs each fit with a ``checkpoint_dir`` under
    ``DF_FAULTS=trainer.fit_step=abort#2`` — ``train_gnn`` at
    ``GNNFitConfig``'s width on the serve leg's probe graph (``hosts`` ×
    ``probes``) and ``train_mlp`` at ``MLP_DIMS`` on the trainer leg's
    pairs (``group_records`` seeded download records), ``epochs`` each —
    and must die by SIGKILL as epoch 2 starts. The newest snapshot,
    restored onto the device, must equal what the child saved bit for bit;
    the fit resumed here must run the last 2 epochs only, clear its
    snapshots and land on an uninterrupted run's parameters: the MLP
    within 1e-6 (``params_equal``), the GNN within the difference of two
    uninterrupted runs (1e-6 where they agree exactly)."""
    import multiprocessing as mp
    import os
    import signal

    from dragonfly2_torch.trainer.checkpoint import FitCheckpointer, params_equal

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    shutil.rmtree(RESUME_WORK, ignore_errors=True)
    RESUME_WORK.mkdir(parents=True)
    children = {}
    try:
        ids, _, peers, rtts = probe_graph(hosts, probes, rng)
        topo = RESUME_WORK / "topology.dfb"
        topo.write_bytes(encode_blocks(wire.encode_topology_block, topology_records(ids, peers, rtts, rng)))
        graph = build_probe_graph(wire.read_columns(topo), max_degree=TrainingConfig.gnn_max_degree)
        group = RESUME_WORK / "group.dfb"
        group.write_bytes(encode_blocks(wire.encode_train_block, synth.make_download_records(group_records, seed=seed)))
        pairs = wire.read_train_pairs(group)
        fits = {
            "gnn": (graph, dict(epochs=epochs, seed=seed)),
            "mlp": ((pairs.features, pairs.labels),
                    dict(hidden_dims=tuple(MLP_DIMS[1:-1]), batch_size=mlp_batch, epochs=epochs, seed=seed)),
        }
        dirs = {kind: RESUME_WORK / f"{kind}-snapshots" for kind in fits}
        ctx = mp.get_context("spawn")
        armed = os.environ.get("DF_FAULTS")
        os.environ["DF_FAULTS"] = RESUME_FAULTS  # the children read it at import
        t0 = time.perf_counter()
        try:
            for kind, (data, config) in fits.items():
                recv, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(target=_resume_child, args=(send, kind, data, dirs[kind], config, str(device),
                                                                 torch.get_num_threads()))
                proc.start()
                send.close()
                children[kind] = (proc, recv)
        finally:
            if armed is None:
                del os.environ["DF_FAULTS"]
            else:
                os.environ["DF_FAULTS"] = armed
        saved = {}
        for kind, (proc, recv) in children.items():
            saved[kind] = {}
            try:
                while True:
                    epoch, digest = recv.recv()
                    saved[kind][epoch] = digest
            except EOFError:
                pass
            proc.join(600)
            check(proc.exitcode == -signal.SIGKILL,
                  f"resume: the {kind} fit's process ended with {proc.exitcode}, not by SIGKILL")
        child_s = time.perf_counter() - t0
        out = {"child_s": child_s, "epochs": epochs, "edges": len(graph.edge_src), "pairs": len(pairs.labels)}
        for kind, (data, config) in fits.items():
            check(sorted(saved[kind]) == [0, 1], f"resume: the {kind} child saved epochs {sorted(saved[kind])}")
            ckpt = FitCheckpointer(dirs[kind])
            check(ckpt.latest_epoch() == 1, f"resume: the {kind} snapshots end at epoch {ckpt.latest_epoch()}")
            t0 = time.perf_counter()
            epoch, state = ckpt.restore_latest(device)
            sync(device)
            restore_ms = (time.perf_counter() - t0) * 1e3
            check(all(t.device.type == device.type for t in state["params"].values()),
                  f"resume: the {kind} snapshot was not restored onto the device")
            check(state_digest(state) == saved[kind][1],
                  f"resume: the restored {kind} snapshot differs from what the child saved")
            t0 = time.perf_counter()
            resumed = _resume_fit(kind, data, dirs[kind], config, device)
            sync(device)
            resume_s = time.perf_counter() - t0
            check(len(resumed.history) == epochs - 2, f"resume: the {kind} fit ran {len(resumed.history)} epochs")
            check(not dirs[kind].exists(), f"resume: the {kind} fit left its snapshots behind")
            full = _resume_fit(kind, data, None, config, device)
            diff = max_abs_diff(resumed.params, full.params)
            st = {"restore_ms": restore_ms, "resume_s": resume_s, "resumed_epochs": len(resumed.history),
                  "max_abs_diff": diff}
            if kind == "mlp":
                limit = 1e-6
                ok = params_equal(full.params, resumed.params, atol=limit)
                note = ""
            else:
                # the gather's backward may accumulate in another order run
                # to run on the card: two uninterrupted runs set the limit
                again = _resume_fit(kind, data, None, config, device)
                st["run_to_run_diff"] = max_abs_diff(again.params, full.params)
                limit = st["run_to_run_diff"] or 1e-6
                ok = diff <= limit
                note = f"; two uninterrupted runs differ by {st['run_to_run_diff']:.3g}"
            st["limit"] = limit
            print(
                f"resume[{device}]: {kind}: SIGKILLed after the snapshots of epochs 0 and 1; epoch {epoch}"
                f" restored onto {device.type} in {restore_ms:.1f} ms, bit for bit what the child saved;"
                f" {len(resumed.history)} epochs resumed in {resume_s:.2f}s; max|resumed - uninterrupted|"
                f"={diff:.3g} (limit {limit:.3g}{note})"
            )
            check(ok, f"resume: the resumed {kind} fit differs from an uninterrupted one by {diff:.3g}")
            out[kind] = st
        print(f"resume[{device}]: the two spawned children ran until killed in {child_s:.1f}s")
        return out
    finally:
        for proc, recv in children.values():
            if proc.is_alive():
                proc.kill()
            proc.join(60)
            recv.close()
        shutil.rmtree(RESUME_WORK, ignore_errors=True)


FEDERATION_WORK = Path(__file__).resolve().parent / "build" / "federation"
# download records of the trainer leg's upload group per scheduler host,
# and the form it uploaded them in
FEDERATION_SHARDS = ((800, "binary"), (600, "binary"), (400, "binary"), (200, "csv"))
FEDERATION_TOL = 1e-6


def federation_phase(device, group_records=2000, shards=FEDERATION_SHARDS, batch=128, epochs=3, seed=0) -> dict:
    """One FedAvg round on ``device``: the trainer leg's upload group
    (``group_records`` seeded download records) split into ``shards``, one
    scheduler host each, in trainer storage as that host uploaded it
    (train blocks or CSV); ``Training.federated_round`` fits each shard,
    merges the fits and sends ``CreateModel`` to the in-process manager
    shortcut. That upload must be the round's only one, under ``federated_model_id_v1()``
    with hostname ``federated``; its params must be within
    ``FEDERATION_TOL`` (relative to each leaf's largest) of
    ``fedavg_trees`` over the per-host fits recomputed here, each weighted
    by its training pairs; its holdout mse must beat the mean
    predictor's on the same holdout."""
    from dragonfly2_torch.parallel.fedavg import fedavg_trees
    from dragonfly2_torch.schema import native
    from dragonfly2_torch.schema.columnar import write_csv
    from dragonfly2_torch.trainer import federation
    from dragonfly2_torch.trainer.train import train_mlp
    from dragonfly2_torch.utils.idgen import federated_model_id_v1, host_id_v2

    device = torch.device(device)
    check(sum(n for n, _ in shards) <= group_records, "the shards hold more records than the group")
    shutil.rmtree(FEDERATION_WORK, ignore_errors=True)
    FEDERATION_WORK.mkdir(parents=True)
    try:
        recs = synth.make_download_records(group_records, seed=seed)
        storage = TrainerStorage(FEDERATION_WORK / "storage")
        at, hosts = 0, []
        for k, (n, form) in enumerate(shards):
            host_id = host_id_v2(f"10.0.1.{k}", f"scheduler-{k}")
            shard = recs[at : at + n]
            at += n
            if form == "csv":
                path = FEDERATION_WORK / f"shard-{k}.csv"
                write_csv(path, shard)
                storage.append_download(host_id, path.read_bytes())
            else:
                storage.append_download_blocks(host_id, encode_blocks(wire.encode_train_block, shard))
            hosts.append(host_id)
        manager = _Manager()
        cfg = FitConfig(hidden_dims=tuple(MLP_DIMS[1:-1]), batch_size=batch, epochs=epochs, seed=seed)
        training = Training(storage, ManagerUploader(manager, PlainRequests()),
                            TrainingConfig(mlp=cfg, auto_mesh=False), device=device)
        t0 = time.perf_counter()
        metrics = training.federated_round()
        sync(device)
        round_s = time.perf_counter() - t0
        check(manager.calls == {"CreateModel": 1} and list(manager.created) == [federated_model_id_v1()],
              f"federation: the round sent {manager.calls} for {list(manager.created)}")
        up = manager.created[federated_model_id_v1()]
        check((up.type, up.hostname) == ("mlp", "federated"), f"federation: uploaded {up.type} as {up.hostname}")

        # the per-host fits again, as federated_fit_mlp splits each shard
        t0 = time.perf_counter()
        fits, weights, eval_y, examples = [], [], [], {}
        for host_id in sorted(hosts):
            pairs = federation._host_pairs(storage, host_id)
            n = pairs.features.shape[0]
            perm = np.random.default_rng(cfg.seed).permutation(n)
            n_eval = max(1, int(n * 0.1))
            ev, tr = perm[:n_eval], perm[n_eval:]
            fits.append(train_mlp(pairs.features[tr], pairs.labels[tr], config=cfg, device=device).params.state_dict())
            weights.append(float(len(tr)))
            eval_y.append(pairs.labels[ev])
            examples[host_id] = len(tr)
        merged = fedavg_trees(fits, weights)
        check_s = time.perf_counter() - t0
        got = {k.replace("/", "."): v for k, v in np.load(io.BytesIO(up.weights)).items()}
        check(got.keys() == merged.keys(), "federation: the upload holds other parameters than the merge")
        err = max(float(np.abs(got[k] - merged[k].cpu().numpy()).max()
                        / max(float(merged[k].abs().max()), 1e-30)) for k in merged)
        mean = mean_mse(np.concatenate(eval_y))
        # the CSV shard decodes through the native decoder (federation._host_pairs)
        csv_native = native.available()
        check(csv_native or all(form != "csv" for _, form in shards),
              "federation: the CSV shard did not take the native decoder")
        out = {"round_s": round_s, "check_s": check_s, "hosts": len(hosts), "examples": examples,
               "merge_rel_err": err, "mse": metrics["mse"], "mae": metrics["mae"], "mean_predictor_mse": mean,
               "csv_native": csv_native}
        print(
            f"federation[{device}]: {len(hosts)} hosts ({', '.join(f'{n} records {f}' for n, f in shards)}) →"
            f" {sum(examples.values())} training pairs, one CreateModel {up.model_id[:12]}… as"
            f" '{up.hostname}' in {round_s:.2f}s; merged params vs fedavg_trees of the per-host fits refit"
            f" ({check_s:.2f}s): max rel err {err:.3g} (tol {FEDERATION_TOL:g}); holdout mse"
            f" {metrics['mse']:.5f} (mean predictor {mean:.5f})"
        )
        check(err <= FEDERATION_TOL, "federation: the merged upload is not fedavg_trees of the per-host fits")
        check(np.isfinite(metrics["mse"]) and metrics["mse"] < mean,
              "federation: the merged model does not beat the mean predictor on its holdout")
        return out
    finally:
        shutil.rmtree(FEDERATION_WORK, ignore_errors=True)


NATIVE_WORK = Path(__file__).resolve().parent / "build" / "native"
NATIVE_PREFIX_MIB = 8  # the CSV prefix held bit for bit against the numpy route
NATIVE_ROUND_GNN_EPOCHS = 2  # the CSV round's GNN leg: the route, not the fit


def csv_download_file(path: Path, file_mib: int, group_records: int, seed: int) -> int:
    """One download CSV as the record sink writes it (``write_csv``): a
    header, then ``group_records`` seeded records' rows repeated to
    ``file_mib`` MiB → the download records it holds."""
    from dragonfly2_torch.schema.columnar import write_csv

    group = path.with_suffix(".group.csv")
    write_csv(group, synth.make_download_records(group_records, seed=seed))
    header, rows = group.read_bytes().split(b"\n", 1)
    group.unlink()
    reps = max(1, -(-(file_mib << 20) // len(rows)))
    with open(path, "wb") as f:
        f.write(header + b"\n")
        for _ in range(reps):
            f.write(rows)
    return reps * group_records


def native_phase(device, file_mib=FILE_MIB, prefix_mib=NATIVE_PREFIX_MIB, hosts=10_000, probes=16,
                 group_records=2000, mlp_batch=FitConfig.batch_size,
                 streaming_threshold_bytes=TrainingConfig.streaming_threshold_bytes, seed=0) -> dict:
    """The native CSV decoder (``csrc/dfnative.cc``, built with g++ at first
    use): the build's seconds; decode MiB/s of one ``file_mib`` MiB download
    CSV through ``decode_pairs_file`` and through ``stream_pairs_file`` over
    spans at the default number of producers (``ingest.stream_shards``);
    the decoder bit for bit against the numpy route (``read_csv`` →
    ``extract_pair_features``) on a record-aligned ``prefix_mib`` MiB
    prefix; the serve leg's probe graph as a topology CSV through
    ``build_probe_graph_file`` against ``build_probe_graph``; then that
    upload round (the CSV file and the topology CSV) through ``Training``
    on ``device``: the MLP leg must take the streamed fit (one
    ``trainer.stream_done``) on the native route, and its holdout mse must
    beat the mean predictor's."""
    from dragonfly2_torch.schema import native
    from dragonfly2_torch.schema.columnar import read_csv, write_csv
    from dragonfly2_torch.schema.features import extract_pair_features
    from dragonfly2_torch.trainer.ingest import default_workers, stream_shards
    from dragonfly2_torch.utils.idgen import host_id_v2

    device = torch.device(device)
    shutil.rmtree(NATIVE_WORK, ignore_errors=True)
    NATIVE_WORK.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        check(native.available(), "the native decoder did not build")
        load_s = time.perf_counter() - t0
        build_s = native.build_seconds
        path = NATIVE_WORK / "download.csv"
        t0 = time.perf_counter()
        records = csv_download_file(path, file_mib, group_records, seed)
        mib = path.stat().st_size / 2**20
        made_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        pairs = native.decode_pairs_file(path)
        decode_s = time.perf_counter() - t0
        check(pairs.num_downloads == records and pairs.features.shape[0] > 0, "decode_pairs_file lost records")
        workers = default_workers()
        t0 = time.perf_counter()
        streamed = rows = 0
        for feats, _, rows in stream_shards(path, workers=workers, half=True):
            streamed += feats.shape[0]
        stream_s = time.perf_counter() - t0
        check(streamed == pairs.features.shape[0] and rows == records, "the stream lost pairs")

        data = path.read_bytes()[: prefix_mib << 20]
        prefix = NATIVE_WORK / "prefix.csv"
        prefix.write_bytes(data[: data.rindex(b"\n") + 1])
        got = native.decode_pairs_file(prefix)
        want = extract_pair_features(records_to_columns(read_csv(prefix, R.DownloadRecord)))
        prefix_equal = all(
            np.array_equal(getattr(got, k), getattr(want, k)) for k in ("features", "labels", "download_index")
        ) and got.num_downloads == want.num_downloads
        check(prefix_equal, "the native decode differs from the numpy route on the prefix")

        rng = np.random.default_rng(seed)
        ids, _, peers, rtts = probe_graph(hosts, probes, rng)
        topo = topology_records(ids, peers, rtts, rng)
        topo_path = NATIVE_WORK / "topology.csv"
        write_csv(topo_path, topo)
        t0 = time.perf_counter()
        g = native.build_probe_graph_file(topo_path)
        graph_native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        w = build_probe_graph(records_to_columns(topo))
        graph_numpy_s = time.perf_counter() - t0
        graph_equal = g.node_ids == w.node_ids and g.num_records == w.num_records and all(
            np.array_equal(getattr(g, k), getattr(w, k))
            for k in ("node_features", "edge_src", "edge_dst", "edge_rtt_log_ms", "neighbors", "neighbor_mask")
        )
        check(graph_equal, "build_probe_graph_file differs from build_probe_graph")

        storage = TrainerStorage(NATIVE_WORK / "storage")
        host_id = host_id_v2(TRAINER_IP, TRAINER_HOST)
        storage.append_download(host_id, path.read_bytes())
        storage.append_network_topology(host_id, topo_path.read_bytes())
        manager = _Manager()
        config = TrainingConfig(mlp=FitConfig(batch_size=mlp_batch),
                                gnn=GNNFitConfig(epochs=NATIVE_ROUND_GNN_EPOCHS), gru=False,
                                streaming_workers=1, streaming_threshold_bytes=streaming_threshold_bytes)
        training = Training(storage, ManagerUploader(manager, PlainRequests()), config, device=device)
        check(training._use_streaming(storage.download_path(host_id), 0, False),
              "the CSV upload would not take the streamed fit")
        since = time.time_ns()
        t0 = time.perf_counter()
        outcome = training.train(TRAINER_IP, TRAINER_HOST)
        sync(device)
        round_s = time.perf_counter() - t0
        check(outcome.ok, f"the CSV round failed: {outcome.mlp_error} {outcome.gnn_error}")
        done = [e for e in flight.snapshot(["trainer"])["trainer"]
                if e["ts_ns"] >= since and e["type"] == "trainer.stream_done"]
        check(len(done) == 1, "the CSV upload's MLP leg did not take the streamed fit")
        cap = 16 * config.mlp.batch_size
        eval_every = max(2, round(1.0 / config.mlp.eval_fraction))
        shards = [(f, l) for f, l, _ in native.stream_pairs_file(path, half=True)]
        y = holdout_labels(shards, eval_every, cap, len(shards) * config.streaming_passes)
        mean = mean_mse(y)
        out = {
            "build_s": build_s, "load_s": load_s, "file_mib": mib, "records": records,
            "pairs": int(pairs.features.shape[0]), "made_s": made_s,
            "decode_mib_s": mib / decode_s, "stream_mib_s": mib / stream_s, "stream_workers": workers,
            "prefix_mib": prefix.stat().st_size / 2**20, "prefix_equal": prefix_equal,
            "graph_nodes": g.num_nodes, "graph_edges": len(g.edge_src), "graph_equal": graph_equal,
            "graph_native_s": graph_native_s, "graph_numpy_s": graph_numpy_s,
            "round_s": round_s, "streamed": True, "steps": done[0]["steps"],
            "mse": outcome.mlp_metrics["mse"], "mean_predictor_mse": mean,
        }
        print(
            f"native[{device}]: g++ build {build_s if build_s is not None else 'cached'} s (load {load_s:.2f} s);"
            f" {mib:.1f} MiB CSV ({records} records, {out['pairs']} pairs; made in {made_s:.1f}s):"
            f" decode_pairs_file {out['decode_mib_s']:.1f} MiB/s, stream_pairs_file over {workers} producers"
            f" {out['stream_mib_s']:.1f} MiB/s; {out['prefix_mib']:.2f} MiB prefix equal to the numpy route"
            f" bit for bit; topology CSV ({len(topo)} records, {g.num_nodes} hosts, {len(g.edge_src)} edges):"
            f" build_probe_graph_file {graph_native_s:.2f}s = build_probe_graph {graph_numpy_s:.2f}s;"
            f" CSV round on {device} in {round_s:.2f}s, streamed MLP fit {done[0]['steps']} steps, holdout"
            f" mse {out['mse']:.5f} (mean predictor {mean:.5f})"
        )
        check(np.isfinite(out["mse"]) and out["mse"] < mean,
              "the CSV round's MLP does not beat the mean predictor on its holdout")
        return out
    finally:
        shutil.rmtree(NATIVE_WORK, ignore_errors=True)


# full-batch steps of train_gnn_sharded on the 10,000-host graph. The fit
# overfits past them: on an H100 its holdout read 0.24601, 0.26401 and
# 0.27952 at 120, 160 and 200 steps (the mean predictor 0.27676), and the
# same fit without a mesh 0.24385, 0.26233 and 0.27945. The shards' own
# arithmetic is held elsewhere: to the reference's histories within 5e-5
# over gloo worlds of 2 and 4 (tests/test_torch_mesh.py), and here to the
# unsharded fit's holdout (MESH_UNSHARDED_TOL)
MESH_SHARDED_EPOCHS = 120
MESH_TOL = 1e-5  # the sharded embed and forward at float32 against the unsharded
# the sharded fit's holdout against the unsharded fit's, relative: bf16 SAGE
# inputs and the gradients' scatter order part them (≤ 8.9e-3 read on an
# H100 at 120–200 steps)
MESH_UNSHARDED_TOL = 5e-2


def mesh_phase(device, hosts=10_000, probes=16, group_records=2000, gnn_epochs=MESH_SHARDED_EPOCHS,
               seed=0) -> dict:
    """The multi-device trainer over a process group of one rank (NCCL on
    the card, gloo on the CPU): ``train_mlp`` over a dp mesh against the
    same fit without one; ``make_sharded_embed`` and
    ``make_sharded_forward`` over a gp mesh on the serve leg's probe graph
    against the unsharded embed and forward at float32 (``MESH_TOL``),
    with the bfloat16 gap against ``GNNScorer`` printed; ``train_gnn_sharded``
    for ``gnn_epochs`` steps, whose holdout mse must beat the mean
    predictor's and read as the same fit's without a mesh
    (``MESH_UNSHARDED_TOL``); ``fedavg_psum`` against ``fedavg_trees``."""
    from dragonfly2_torch.models import gnn_sharded as gs
    from dragonfly2_torch.models.gnn import apply_graphsage, init_graphsage, predict_edge
    from dragonfly2_torch.parallel.fedavg import fedavg_psum, fedavg_trees
    from dragonfly2_torch.schema.features import extract_pair_features
    from dragonfly2_torch.trainer.train import train_gnn, train_gnn_sharded, train_mlp

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1
    )
    try:
        backend = dist.get_backend()
        dp, gp, fed = make_mesh(dp=1), make_mesh(gp=1), make_mesh(fed=1)
        pairs = extract_pair_features(records_to_columns(synth.make_download_records(group_records, seed=seed)))
        cfg = FitConfig(hidden_dims=tuple(MLP_DIMS[1:-1]), batch_size=1024, epochs=2, seed=seed)
        t0 = time.perf_counter()
        meshed = train_mlp(pairs.features, pairs.labels, config=cfg, device=device, mesh=dp)
        sync(device)
        mlp_s = time.perf_counter() - t0
        plain = train_mlp(pairs.features, pairs.labels, config=cfg, device=device)
        mlp_err = max_abs_diff(meshed.params, plain.params)
        hist_err = max(abs(a - b) for a, b in zip(meshed.history, plain.history))

        rng = np.random.default_rng(seed)
        ids, _, peers, rtts = probe_graph(hosts, probes, rng)
        graph = build_probe_graph(records_to_columns(topology_records(ids, peers, rtts, rng)))
        model = init_graphsage(torch.Generator().manual_seed(seed), graph.node_features.shape[1], [64, 64],
                               num_nodes=graph.num_nodes).to(device).requires_grad_(False)
        nf, nbrs, mask, src, dst, _, _ = gs.pad_graph(graph, 1)
        table = gs.pad_rows(model.node_embed.cpu().numpy(), 1)
        local = gs.shard_graph_arrays(gp, "gp", nf, nbrs, mask, src, dst, table, device=device)
        feats_d, nbrs_d, mask_d = (torch.from_numpy(a).to(device) for a in
                                   (graph.node_features, graph.neighbors, graph.neighbor_mask))
        src_d, dst_d = (torch.from_numpy(a).to(device) for a in (graph.edge_src, graph.edge_dst))
        with torch.no_grad():
            t0 = time.perf_counter()
            emb = gs.make_sharded_embed(gp, compute_dtype=torch.float32)(model, local[5], *local[:3])
            sync(device)
            embed_ms = (time.perf_counter() - t0) * 1e3
            fwd = gs.make_sharded_forward(gp, compute_dtype=torch.float32)(model, local[5], *local[:5])
            want_emb = apply_graphsage(model, feats_d, nbrs_d, mask_d, compute_dtype=torch.float32)
            want_fwd = predict_edge(model, want_emb, src_d, dst_d)
            embed_err = float((emb - want_emb).abs().max())
            forward_err = float((fwd - want_fwd).abs().max())
            emb16 = gs.make_sharded_embed(gp)(model, local[5], *local[:3])
        served = GNNScorer(model, graph, device=device)
        bf16_gap = float((emb16 - served._emb).abs().max())

        t0 = time.perf_counter()
        fit = train_gnn_sharded(graph, gp, config=GNNFitConfig(epochs=gnn_epochs, seed=seed), device=device)
        sync(device)
        sharded_s = time.perf_counter() - t0
        train_idx, eval_idx = _split_eval(len(graph.edge_src), GNNFitConfig.eval_fraction, seed)
        mean = mean_mse(graph.edge_rtt_log_ms[eval_idx])
        # the same fit without a mesh (one full-batch step an epoch from the
        # same init): what the holdout reads is the model's, not the shards'
        whole = train_gnn(graph, config=GNNFitConfig(epochs=gnn_epochs, seed=seed, batch_size=len(train_idx)),
                          device=device)
        whole_history_gap = max(abs(a - b) / abs(b) for a, b in zip(fit.history, whole.history))
        whole_mse_gap = abs(fit.metrics["mse"] - whole.metrics["mse"]) / whole.metrics["mse"]

        trees = [meshed.params.state_dict()]
        merged = fedavg_psum(trees[0], len(pairs.labels), mesh=fed)
        host = fedavg_trees(trees, [float(len(pairs.labels))])
        fed_err = max(float((merged[k] - host[k]).abs().max()) for k in host)

        out = {
            "backend": backend, "mlp_s": mlp_s, "mlp_param_err": mlp_err, "mlp_history_err": hist_err,
            "nodes": graph.num_nodes, "edges": len(graph.edge_src), "embed_ms": embed_ms,
            "embed_err": embed_err, "forward_err": forward_err, "bf16_embed_gap": bf16_gap,
            "sharded_s": sharded_s, "sharded_epochs": gnn_epochs, "sharded_mse": fit.metrics["mse"],
            "sharded_mean_predictor_mse": mean, "sharded_history": [fit.history[0], fit.history[-1]],
            "unsharded_mse": whole.metrics["mse"], "unsharded_history_gap": whole_history_gap,
            "unsharded_mse_gap": whole_mse_gap,
            "fedavg_err": fed_err,
        }
        print(
            f"mesh[{device}, {backend} group of 1]: train_mlp over dp=1 in {mlp_s:.2f}s, params"
            f" max|dp - none| {mlp_err:.3g}, losses {hist_err:.3g} (tol 1e-6); sharded embed/forward"
            f" over gp=1 on {graph.num_nodes} hosts / {len(graph.edge_src)} edges at float32: max|embed -"
            f" unsharded| {embed_err:.3g}, max|forward - unsharded| {forward_err:.3g} (tol {MESH_TOL:g}),"
            f" embed {embed_ms:.1f} ms; bf16 embed vs GNNScorer {bf16_gap:.3g}; train_gnn_sharded"
            f" {gnn_epochs} steps in {sharded_s:.2f}s, loss {fit.history[0]:.4f} → {fit.history[-1]:.4f},"
            f" holdout mse {fit.metrics['mse']:.5f} (mean predictor {mean:.5f}; the same fit unsharded"
            f" {whole.metrics['mse']:.5f}, losses apart by {whole_history_gap:.3g} and holdouts by"
            f" {whole_mse_gap:.3g} relative, tol {MESH_UNSHARDED_TOL:g}); fedavg_psum vs fedavg_trees"
            f" {fed_err:.3g}"
        )
        check(mlp_err <= 1e-6 and hist_err <= 1e-6, "train_mlp over a dp mesh differs from the fit without one")
        check(embed_err <= MESH_TOL and forward_err <= MESH_TOL,
              "the sharded embed or forward differs from the unsharded one")
        check(np.isfinite(fit.metrics["mse"]) and fit.metrics["mse"] < mean,
              "train_gnn_sharded does not beat the mean predictor on its holdout")
        check(whole_mse_gap <= MESH_UNSHARDED_TOL, "train_gnn_sharded's holdout differs from the unsharded fit's")
        check(fed_err <= 1e-6, "fedavg_psum differs from fedavg_trees")
        return out
    finally:
        dist.destroy_process_group()


def demand_window(tasks: int, hot: int, now: float, rng: np.random.Generator, **window_kw):
    """A ``DemandWindow`` (its defaults unless ``window_kw`` says otherwise)
    holding ``tasks`` task series over its whole window up to ``now``:
    ``hot`` of them rise bucket by bucket (1 to 2 × the bucket's index),
    the rest stay flat (1 + Poisson(0.5) a bucket) → (window, the hot
    series' task ids)."""
    window = DemandWindow(**window_kw)
    width, t = window.bucket_s, window.window_buckets
    check(tasks <= window.max_tasks, "more tasks than the window holds")
    counts = 1.0 + rng.poisson(0.5, (tasks, t))
    hot_rows = rng.choice(tasks, hot, replace=False)
    counts[hot_rows] = np.round(np.arange(1, t + 1) * rng.uniform(1.0, 2.0, (hot, 1)))
    urls = [f"https://registry.example/v2/app/blobs/sha256:{i:064x}" for i in range(tasks)]
    keys = [task_id_v1(u) for u in urls]
    for i in range(tasks):
        for b in np.flatnonzero(counts[i]):
            window.observe(keys[i], url=urls[i], ts=now - (t - 1 - b) * width, count=float(counts[i, b]))
    return window, {keys[i] for i in hot_rows}


def preheat_leg(
    device, manager, tasks=1024, hot=PREHEAT_HOT, hosts=10_000, probes=16,
    candidates=PREHEAT_CANDIDATES, forecast_epochs=None, seed=0, **window_kw,
) -> dict:
    """The preheat plane on ``device``: a ``DemandWindow`` (1,024 tasks ×
    32 buckets of 10 s at its defaults) holding ``hot`` rising series among
    flat ones, and one ``PreheatPlanner`` sweep — the forecaster's first
    fit inline, the GRU forecast of every series, the plan, and one
    ``CreateJob`` into ``manager`` whose seed ranking is
    ``recommend_seeds_by_rtt`` over the serve leg's engine. The hot series
    must be the ones planned and the job must carry their task ids. The
    forecast of every series on ``device`` is then timed and held against
    the plain numpy version (``FORECAST_TOL``). Last, ``recommend_seeds``
    ranks ``candidates`` hosts with the GNN ``manager`` holds (the trainer
    leg's, over the same probe graph), against the same on the CPU.
    ``forecast_epochs`` cuts the forecaster's fit (``DemandForecaster``'s
    8 epochs when None)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    resource, _ = build_swarm(ids, 0, 0, rng)
    eng = fed(device)
    eng.flush(now=PROBED_AT)
    topology = NetworkTopology(KVStore(), resource.host_manager, engine=eng)
    now = PROBED_AT
    window, hot_ids = demand_window(tasks, hot, now, rng, **window_kw)
    forecaster = DemandForecaster(window.window_buckets, device=device, seed=seed,
                                  **({} if forecast_epochs is None else {"epochs": forecast_epochs}))
    planner = preheat_planner.PreheatPlanner(
        window, forecaster, manager_client=manager, topology=topology, cluster_id=1,
        budget_per_sweep=hot, requests=PlainRequests(),
    )
    # the sweep's phases (fit inside forecast, the seed ranking inside plan)
    phases = {name: getattr(preheat_planner, f"PH_{name.upper()}") for name in
              ("forecast", "fit", "plan", "rank", "place")}
    jobs0, phase0 = len(manager.jobs), {name: ph.total_s for name, ph in phases.items()}
    swept = planner.sweep_once(now=now)
    sync(device)
    phase_s = {name: ph.total_s - phase0[name] for name, ph in phases.items()}
    fit_s = phase_s["fit"]
    check(swept["outcome"] == "planned" and forecaster.fits == 1, f"the sweep planned nothing: {swept}")
    check(next(forecaster._model.parameters()).device.type == device.type, "the forecaster is not on the device")
    check(swept["forecast"] == tasks and len(manager.jobs) == jobs0 + 1, f"the sweep sent no job: {swept}")
    job = manager.jobs[-1]
    args = json.loads(job.args_json)
    planned = {spec["task_id"] for spec in args["tasks"]}
    check(job.type == "preheat" and planned == hot_ids, "the job does not carry the hot series")
    seeds = recommend_seeds_by_rtt(eng, k=planner.seed_k)
    check(len(seeds) == planner.seed_k and args["seed_ranking"] == seeds,
          "the job's seed ranking is not the engine's RTT centrality")

    keys, _, series = window.series_batch(now=now)
    scores = forecaster.forecast_demand(series)
    is_hot = np.array([k in hot_ids for k in keys])
    check(scores.shape == (tasks,) and np.isfinite(scores).all(), "forecast shape")
    check(scores[is_hot].min() > scores[~is_hot].max(), "a flat series forecast above a rising one")
    err = float(np.abs(scores - forecaster.forecast_demand_np(series)).max())
    forecast_ms = wall_ms(lambda: forecaster.forecast_demand(series), 10, device)
    plain_ms = wall_ms(lambda: forecaster.forecast_demand_np(series), 3, torch.device("cpu"))
    print(
        f"preheat[{device}]: window {tasks} tasks x {window.window_buckets} buckets of"
        f" {window.bucket_s:g}s ({hot} rising); sweep {swept['seconds'] * 1e3:.1f} ms with the first fit"
        f" inline ({fit_s:.2f}s), planned {swept['planned']} (the rising ones), one CreateJob with"
        f" seeds {[s['host_id'] for s in seeds]}; forecast of {tasks} series forecast_ms={forecast_ms:.2f}"
        f" (numpy {plain_ms:.2f}) max|card - numpy|={err:.3g} (tol {FORECAST_TOL:g}); the sweep's"
        f" phases in s: " + " ".join(f"{name}={t:.3f}" for name, t in phase_s.items())
    )
    check(err <= FORECAST_TOL, "the forecast differs from its numpy version")

    gnn = deserialize_params_auto(manager.created[gnn_model_id_v1(TRAINER_IP, TRAINER_HOST)].weights)
    pool = [ids[i] for i in rng.choice(hosts, candidates, replace=False)]
    t0 = time.perf_counter()
    best = recommend_seeds(topology, gnn, k=3, candidates=pool, device=device)
    sync(device)
    recommend_ms = (time.perf_counter() - t0) * 1e3
    want_f32 = recommend_seeds(topology, gnn, k=3, candidates=pool, device="cpu")
    with gnn_head_like_the_card():
        want = recommend_seeds(topology, gnn, k=3, candidates=pool, device="cpu")
    means = [r["mean_predicted_rtt_log_ms"] for r in best]
    check(len(best) == 3 and {r["host_id"] for r in best} <= set(pool) and means == sorted(means),
          f"recommend_seeds: {best}")
    seed_err = max(abs(a - b["mean_predicted_rtt_log_ms"]) for a, b in zip(means, want))
    seed_err_f32 = max(abs(a - b["mean_predicted_rtt_log_ms"]) for a, b in zip(means, want_f32))
    print(
        f"preheat[{device}]: recommend_seeds over {candidates} candidates with the trained GNN:"
        f" {[r['host_id'] for r in best]} in {recommend_ms:.1f} ms (the embed of {hosts} hosts"
        f" included); max|mean - cpu(bf16 head)| at each rank {seed_err:.3g} (tol {GNN_SCORE_TOL:g}),"
        f" against a float32 head {seed_err_f32:.3g}"
    )
    check(seed_err <= GNN_SCORE_TOL, "recommend_seeds on the device differs from the CPU's")
    return {
        "tasks": tasks, "buckets": window.window_buckets, "hot": hot, "sweep_ms": swept["seconds"] * 1e3,
        "fit_s": fit_s, "phase_s": phase_s, "planned": swept["planned"], "seeds": [s["host_id"] for s in seeds],
        "forecast_ms": forecast_ms, "forecast_numpy_ms": plain_ms, "forecast_err": err,
        "recommend_ms": recommend_ms, "recommend_err": seed_err,
    }


SERVER_WORK = Path(__file__).resolve().parent / "build" / "server_leg"
SERVER_IP, SERVER_HOST = "10.0.0.3", "scheduler-live"
SERVER_PIECES = 16  # pieces of every task: a seed fetches them, a child reports them
# the daemons' processes: the server's one interpreter is the bound (its
# process at ~100% of a core in a CPU run, each daemon process at ~12%),
# so 4 keep up with it and leave the host's other cores free
SERVER_DAEMON_PROCS = 4


class _ServerRecordingService(ScoringService):
    """The scoring service of a live scheduler: per served call it keeps,
    on the caller's thread, the features and host pairs it scored and what
    it answered (for ``_ServerRecordingEvaluator`` to pick up), and it
    counts the calls each batch launch took."""

    def __init__(self, config=None):
        super().__init__(config)
        self.tls = threading.local()
        self.launches = 0  # batch-loop launches
        self.launch_calls = 0  # calls those launches scored
        self.batch_ms = []  # each launch's wall (pack, forward, rank, hand-back)
        self.errors = []  # (monotonic s, what the service raised) per failed call

    def score_wave(self, features, pairs, counts, budget_s=None):
        try:
            out = super().score_wave(features, pairs, counts, budget_s=budget_s)
        except Exception as exc:
            self.errors.append((time.monotonic(), repr(exc)[:200]))
            raise
        self.tls.last = (np.asarray(features, np.float32).copy(), list(pairs or ()), out, self.model_kind())
        return out

    def _score_batch(self, batch, rows):
        self.launches += 1
        self.launch_calls += len(batch)
        t0 = time.perf_counter()
        try:
            return super()._score_batch(batch, rows)
        finally:
            self.batch_ms.append((time.perf_counter() - t0) * 1e3)


class _ServerRecordingEvaluator(MLEvaluator):
    """The ``ml`` evaluator of a live scheduler, keeping per decision (by
    child peer id) its candidates, the ranking it returned and what the
    scoring service saw and answered for it (None when the decision
    dropped below the serving rung; the evaluator's ``_rung`` is shared by
    every handler thread, so it cannot say this per decision)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.decisions = {}
        self._lock = threading.Lock()

    def evaluate_parents(self, parents, child, total_piece_count):
        svc = self._serving
        if svc is not None:
            svc.tls.last = None
        out = super().evaluate_parents(parents, child, total_piece_count)
        rec = {
            "candidates": [p.id for p in parents],
            "ranked": [p.id for p in out],
            "served": svc.tls.last if svc is not None else None,
        }
        with self._lock:
            self.decisions[child.id] = rec
        return out


def _host_info(cp, ids, i):
    """Host ``i``'s announced info: seeded stats, a location and an idc."""
    return cp.HostInfo(
        id=ids[i], type="super" if i % 50 == 0 else "normal", hostname=ids[i],
        ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", port=65000, download_port=65002,
        concurrent_upload_limit=50,
        cpu=cp.CpuStat(logical_count=32, physical_count=32, percent=float((i * 37) % 100)),
        memory=cp.MemoryStat(total=64 << 30, used_percent=float((i * 11) % 90 + 5)),
        network=cp.NetworkStat(tcp_connection_count=(i * 13) % 2000,
                               upload_tcp_connection_count=(i * 7) % 200,
                               location=f"cn|r{i % 4}|z{i % 8}", idc=f"idc-{i % 16}"),
        disk=cp.DiskStat(used_percent=float((i * 17) % 90 + 5)),
    )


def _daemon_process(conn, threads, hosts, probes, seed, hosts_of, pieces):
    """One process of daemons for the server leg, spawned so that it shares
    neither the server's interpreter lock nor its collector. It answers the
    leg's commands over ``conn``, each a list of jobs run on ``threads``
    client threads, with ``("ok", results in order)`` or ``("error",
    traceback)``: ``("dial", [address])``; ``("announce", host indices)``
    (``AnnounceHost``); ``("probes", [(host, lo, hi, created_at_ns,
    ask)])`` (one ``SyncProbes`` stream: with ``ask`` the targets it is
    named first, then the results of its seeded probes ``lo:hi``);
    ``("peers", [(task, k, host, back_to_source)])`` (one ``AnnouncePeer``
    stream → (peer id, response kind, parent ids, register-sent and
    response ``time.monotonic()``)); ``("stop", None)``. The probe graph
    is redrawn from ``seed`` as the leg drew it; ``hosts_of[t][k]`` is the
    host of task ``t``'s ``k``-th peer."""
    import queue
    import traceback

    from dragonfly2_torch.rpc import glue, protos

    sp, cp = protos.load("scheduler_pb2"), protos.load("common_pb2")
    ids, fed, probed, rtts = probe_graph(hosts, probes, np.random.default_rng(seed))
    coords = fed.coords
    infos = [None] * hosts
    conns = {}

    def info(i):
        if infos[i] is None:
            infos[i] = _host_info(cp, ids, i)
        return infos[i]

    def announce(i):
        conns["client"].AnnounceHost(sp.AnnounceHostRequest(host=info(i)))

    def sync_probes(job):
        i, lo, hi, at_ns, ask = job
        q = queue.Queue()
        responses = conns["client"].SyncProbes(iter(q.get, None))
        named = 0
        if ask:
            q.put(sp.SyncProbesRequest(host=info(i), probe_started=sp.ProbeStartedRequest()))
            named = len(next(responses).hosts)
        q.put(sp.SyncProbesRequest(host=info(i), probe_finished=sp.ProbeFinishedRequest(probes=[
            sp.ProbeResult(host_id=ids[int(j)], rtt_ns=int(r), created_at_ns=at_ns)
            for j, r in zip(probed[i][lo:hi], rtts[i][lo:hi])
        ])))
        q.put(None)
        for _ in responses:
            pass
        return named

    def run_peer(spec):
        t, k, hi, demand = spec
        task_id, peer_id = f"layer-{t:02d}", f"peer-{t:02d}-{k:03d}"
        base = dict(host_id=ids[hi], task_id=task_id, peer_id=peer_id)
        q = queue.Queue()
        stream = conns["client"].AnnouncePeer(iter(q.get, None))
        t_reg = time.monotonic()
        q.put(sp.AnnouncePeerRequest(**base, register_peer=sp.RegisterPeerRequest(
            task_id=task_id, peer_id=peer_id, url=f"https://registry.example/v2/app/blobs/{task_id}",
            need_back_to_source=demand,
        )))
        resp = next(stream)
        t_resp = time.monotonic()
        kind = resp.WhichOneof("response")
        parents = [c.peer_id for c in resp.normal_task.candidate_parents] if kind == "normal_task" else []
        # the pieces come from the head of the ranking; a piece takes
        # longer from a farther or busier parent (the probe graph's
        # latent coordinates), back to source longest
        noise = np.random.default_rng([seed, t, k]).lognormal(0.0, 0.1, pieces)
        src = parents[0] if parents else ""
        cost = np.full(pieces, 40e6) * noise
        if src:
            ph = int(hosts_of[int(src[5:7])][int(src[8:])])  # "peer-TT-KKK"
            rtt_ms = 1.0 + 80.0 * float(np.linalg.norm(coords[hi] - coords[ph]))
            # the parent's load is its announced cpu percent
            cost = (2.0 + 0.25 * rtt_ms + 0.4 * float((ph * 37) % 100)) * 1e6 * noise
        if kind == "normal_task":
            q.put(sp.AnnouncePeerRequest(**base, download_peer_started=sp.DownloadPeerStartedRequest()))
            traffic = "remote_peer"
        else:
            q.put(sp.AnnouncePeerRequest(
                **base, download_peer_back_to_source_started=sp.DownloadPeerBackToSourceStartedRequest()))
            traffic = "back_to_source"
        for n in range(pieces):
            q.put(sp.AnnouncePeerRequest(**base, download_piece_finished=sp.DownloadPieceFinishedRequest(
                piece=cp.PieceInfo(number=n, parent_id=src, offset=n << 22, length=4 << 20,
                                   traffic_type=traffic, cost_ns=int(cost[n]), created_at_ns=time.time_ns()))))
        q.put(sp.AnnouncePeerRequest(**base, download_peer_finished=sp.DownloadPeerFinishedRequest(
            content_length=pieces << 22, piece_count=pieces, cost_ns=int(cost.sum()))))
        q.put(None)
        for _ in stream:
            pass
        return peer_id, kind, parents, t_reg, t_resp

    def dial(address):
        conns["channel"] = glue.dial(address)
        conns["client"] = glue.ServiceClient(conns["channel"], glue.SCHEDULER_SERVICE)

    jobs = {"dial": dial, "announce": announce, "probes": sync_probes, "peers": run_peer}
    try:
        with ThreadPoolExecutor(threads) as pool:
            while True:
                cmd, items = conn.recv()
                if cmd == "stop":
                    break
                try:
                    conn.send(("ok", list(pool.map(jobs[cmd], items))))
                except Exception:
                    conn.send(("error", traceback.format_exc()))
    finally:
        if "channel" in conns:
            conns["channel"].close()
        conn.close()


class _Daemons:
    """``procs`` spawned daemon processes (``_daemon_process``) of
    ``threads`` client threads each. ``map(cmd, items)`` deals the items
    out round-robin, runs them in every process at once and returns the
    results in the items' order."""

    def __init__(self, procs, threads, **graph):
        import multiprocessing

        # spawn, never fork: this process holds a CUDA context
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for _ in range(procs):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_daemon_process, args=(there, threads), kwargs=graph, daemon=True)
            proc.start()
            there.close()
            self.conns.append(here)
            self.procs.append(proc)

    def map(self, cmd, items):
        n = len(self.conns)
        for w, conn in enumerate(self.conns):
            conn.send((cmd, items[w::n]))
        out, errors = [None] * len(items), []
        for w, conn in enumerate(self.conns):
            status, got = conn.recv()
            if status == "ok":
                out[w::n] = got
            else:
                errors.append(got)
        check(not errors, "a daemon process failed:\n" + "\n".join(errors))
        return out

    def close(self):
        for conn in self.conns:
            try:
                conn.send(("stop", None))
            except OSError:
                pass  # that process is gone already
        for proc in self.procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()


# a sample line of the text exposition or of OpenMetrics (an exemplar
# after a histogram bucket's value in the latter)
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)(?: # \{[^}]*\} \S+ \S+)?$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')
OPENMETRICS = "application/openmetrics-text; version=1.0.0"


def http_get(url: str, accept: "str | None" = None) -> "tuple[int, str, bytes, float]":
    """GET ``url`` → (status, content type, body, ms)."""
    import urllib.request

    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = resp.read()
        return resp.status, resp.headers.get("Content-Type", ""), body, (time.perf_counter() - t0) * 1e3


def parse_exposition(text: str, openmetrics: bool) -> dict:
    """Every line of a /metrics body → {series: value}, the series keyed as
    the telemetry snapshot keys them (``name{a=b}``); a line that is no
    HELP, TYPE or sample line fails, and so does OpenMetrics without its
    closing ``# EOF``."""
    lines = text.rstrip("\n").split("\n")
    if openmetrics:
        check(lines[-1] == "# EOF", "the OpenMetrics exposition does not end with # EOF")
        lines = lines[:-1]
    out = {}
    for line in lines:
        if line.startswith(("# HELP ", "# TYPE ")):
            continue
        m = _SAMPLE.match(line)
        check(m is not None, f"an exposition line does not parse: {line!r}")
        labels = ",".join(f"{k}={v}" for k, v in _LABEL.findall(m.group(2) or ""))
        out[m.group(1) + (f"{{{labels}}}" if labels else "")] = float(m.group(3))
    return out


def scrape_checks(name: str, metrics_addr: str, held: dict, own: dict, before: dict) -> dict:
    """One server's scrape port: /metrics in the text format and in
    OpenMetrics (every line parses), /healthz (200, every service ``ok``),
    each /debug endpoint (200, JSON); then each counter of ``own`` (series
    → what the leg itself counted since ``before``) must read the same in
    what the manager's telemetry plane holds (``held``, ``plane_view``), in
    the scrape, and ``before`` + the leg's count. → scrape ms and series counts."""
    base = f"http://{metrics_addr}"
    status, ctype, body, text_ms = http_get(base + "/metrics")
    check(status == 200 and ctype.startswith("text/plain"), f"{name}: /metrics answered {status} {ctype}")
    text = parse_exposition(body.decode(), openmetrics=False)
    status, ctype, body, om_ms = http_get(base + "/metrics", accept=OPENMETRICS)
    check(status == 200 and ctype.startswith("application/openmetrics-text"),
          f"{name}: /metrics with OpenMetrics asked for answered {status} {ctype}")
    om = parse_exposition(body.decode(), openmetrics=True)
    om_bytes = len(body)
    status, _, body, health_ms = http_get(base + "/healthz")
    health = json.loads(body)
    check(status == 200 and health["status"] == "ok" and health["services"]
          and all(v == "ok" for v in health["services"].values()), f"{name}: /healthz {status} {health}")
    for path in ("/debug/ring", "/debug/prof", "/debug/flows", "/debug/swarm", "/debug/faults"):
        status, ctype, body, _ = http_get(base + path)
        check(status == 200 and ctype == "application/json", f"{name}: {path} answered {status} {ctype}")
        json.loads(body)
    for series, n in own.items():
        want = before.get(series, 0.0) + n
        got = (held["counters"].get(series), text.get(series), om.get(series))
        check(got == (want, want, want),
              f"{name}: {series} is {got} (manager's plane, text scrape, OpenMetrics scrape), not {want}")
    pushed = {k: v for kind in ("counters", "gauges") for k, v in held[kind].items()}
    agree = sum(text.get(k) == v for k, v in pushed.items())
    print(
        f"server: {name} scrape: /metrics {text_ms:.2f} ms ({len(text)} series, {om_bytes} B OpenMetrics in"
        f" {om_ms:.2f} ms), /healthz {health_ms:.2f} ms; {len(own)} counters the leg counted agree in the"
        f" push, both scrapes and the leg; {agree} of the {len(pushed)} pushed counters and gauges read"
        f" the same in the scrape"
    )
    return {"scrape_ms": text_ms, "scrape_om_ms": om_ms, "healthz_ms": health_ms, "series": len(text),
            "pushed_series": len(pushed), "pushed_agree": agree}


def manager_checks(mgr, addr: str, reporters: set, rest: _Rest) -> dict:
    """The port's manager after a leg: its telemetry plane's snapshot names
    every reporter in ``reporters`` ((service, instance) pairs) live, and
    the REST front's ``GET /api/v1/telemetry`` names the same reporters as
    the plane that the gRPC pushes fold into; ``GET /`` serves the port's
    console page byte for byte; its /healthz answers 200 with the plane's
    SLO section, its /metrics parses, and, when it runs the certificate
    authority, ``IssueCertificate`` signs a CSR into a chain that verifies
    against the CA. → ms of each."""
    from dragonfly2_torch.manager.console import index_html

    t0 = time.perf_counter()
    snap = mgr.telemetry.snapshot()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    live = {(r["service"], r["instance"]) for r in snap["services"] if not r["stale"]}
    check(reporters <= live, f"manager: the plane's snapshot lacks {reporters - live}")
    over_rest = rest.call("GET", "/api/v1/telemetry", token="")
    named = {(r["service"], r["instance"]) for r in over_rest["services"]}
    check(named == {(r["service"], r["instance"]) for r in snap["services"]} and reporters <= named,
          f"manager: the REST snapshot names {sorted(named)}, the plane {sorted(live)}")
    check(rest.call("GET", "/", token="", raw=True) == index_html(),
          "manager: the REST front's console is not the port's index.html")
    status, _, body, health_ms = http_get(f"http://{mgr.metrics_addr}/healthz")
    health = json.loads(body)
    check(status == 200 and health["status"] == "ok" and set(health["slo"]["slos"]) >= {"download_success"},
          f"manager: /healthz {status} {health}")
    status, _, body, _ = http_get(f"http://{mgr.metrics_addr}/metrics")
    check(status == 200, f"manager: /metrics answered {status}")
    series = parse_exposition(body.decode(), openmetrics=False)
    out = {"snapshot_ms": snapshot_ms, "healthz_ms": health_ms, "series": len(series),
           "breached": health["slo"]["breached"], "issue_certs": mgr.service.ca is not None}
    if mgr.service.ca is not None:
        from cryptography import x509
        from cryptography.hazmat.primitives.asymmetric import padding

        from dragonfly2_torch.utils.issuer import obtain_certificate

        t0 = time.perf_counter()
        _, leaf_pem, ca_pem = obtain_certificate(addr, "leg-peer", hosts=["127.0.0.1", "leg-peer"])
        out["issue_ms"] = (time.perf_counter() - t0) * 1e3
        leaf, ca = x509.load_pem_x509_certificate(leaf_pem), x509.load_pem_x509_certificate(ca_pem)
        ca.public_key().verify(leaf.signature, leaf.tbs_certificate_bytes, padding.PKCS1v15(),
                               leaf.signature_hash_algorithm)
        check(leaf.issuer == ca.subject, "manager: the issued certificate's issuer is not the CA")
    print(f"manager: plane snapshot {snapshot_ms:.2f} ms ({len(snap['services'])} reporters), /healthz"
          f" {health_ms:.2f} ms (SLOs breached: {out['breached']}), /metrics {len(series)} series"
          + (f", IssueCertificate {out['issue_ms']:.1f} ms (chain verified)" if "issue_ms" in out
             else ", no certificate authority"))
    return out


def server_leg(
    device, hosts=10_000, probes=16, tasks=40, peers=256, concurrency=64,
    phase2=256, probe_rounds=3, gnn_epochs=60, mlp_batch=512, seed=0,
) -> dict:
    """The port's scheduler and trainer servers on ``device``, live over
    gRPC in this process: the port's ``ManagerServer`` as shipped
    (``manager_server``), a ``TrainerServer`` and a ``SchedulerServer``
    (``algorithm="ml"``) wired to it. The daemons' side runs in
    ``SERVER_DAEMON_PROCS`` spawned processes (``_Daemons``), gRPC clients
    speaking raw ``scheduler_pb2`` through the port's ``ServiceClient``,
    ``concurrency`` streams in all; the server's process keeps its
    interpreter and its collector as a deployment has them. ``hosts``
    hosts announce and sync ``probes`` seeded probes each, in
    ``probe_rounds`` rounds with a topology snapshot after each (a
    snapshot keeps each host's 5 newest edges, so rounds of at most 5
    probes carry the whole probe graph to the trainer, and the default
    rounds of 5, 5 and 6 all but one edge of each host); phase 1 runs
    ``tasks`` × ``peers`` ``AnnouncePeer`` streams (one back-to-source seed per task, then
    children scheduled on earlier peers), scored by a seeded MLP the
    refresher installed once it was activated (uploaded inactive, a poll
    before ``UpdateModel(state="active")`` must install nothing); the
    announcer uploads phase 1's records and the probe snapshots to the
    trainer, which fits MLP, GNN and GRU and sends three ``CreateModel``;
    they land inactive, a poll installs nothing, the leg activates each
    and the next poll installs them (activation → installed timed); phase 2 runs
    ``phase2`` more children on the trained GNN, the GRU behind bad-node
    detection. Every decision is checked (a legal parent set — peers of
    the child's task registered before its answer — or a legitimate
    back-to-source) and so is the server's side (rung ``serving`` after
    warm-up, order = ``rank_order`` of its card scores), and every served
    call is rescored on the CPU. Both servers run as shipped with a
    manager: each pushes telemetry every 15 s (``telemetry_interval``'s
    default) and serves /metrics on a port of its own; after the last
    decision each reporter pushes once more, and its pushes, what the
    manager's telemetry plane holds of it, both expositions, /healthz and
    the /debug endpoints are checked (``scrape_checks``), and so are the
    plane's snapshot and the manager's /healthz with its SLO section. The
    server process's cyclic collections during traffic are timed
    (``gc.callbacks``), not changed."""
    import gc
    import inspect

    from dragonfly2_torch.utils.telemetry import registry_snapshot

    from dragonfly2_torch.rpc import glue
    from dragonfly2_torch.scheduler import server as sched_server
    from dragonfly2_torch.scheduler import serving as serving_mod
    from dragonfly2_torch.scheduler.server import SchedulerServer, SchedulerServerConfig
    from dragonfly2_torch.trainer import training as training_mod
    from dragonfly2_torch.trainer.server import TrainerServer, TrainerServerConfig
    from dragonfly2_torch.trainer.train import train_gnn

    pieces = SERVER_PIECES
    # glue.serve's pool: one worker per open AnnouncePeer stream
    workers = inspect.signature(glue.serve).parameters["max_workers"].default
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ids, fed, _, _ = probe_graph(hosts, probes, rng)
    per_task = phase2 // tasks + 1
    hosts_of = [rng.choice(hosts, peers + per_task, replace=False) for _ in range(tasks)]
    # the daemons start first: their imports overlap the servers' build
    procs = min(SERVER_DAEMON_PROCS, concurrency)
    daemons = _Daemons(procs, concurrency // procs, hosts=hosts, probes=probes, seed=seed,
                       hosts_of=[h.tolist() for h in hosts_of], pieces=pieces)
    mgr = ops_channel = srv = trainer = None
    # collector generation → [collections, longest wall ms, total wall ms,
    # longest ms on the collecting thread's clock]: a collection's wall
    # counts the time other threads ran while a finalizer had released
    # the interpreter lock; its thread time is the pause it imposed
    pauses = {}
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = (time.perf_counter(), time.thread_time())
        elif "t" in started:
            t0, c0 = started.pop("t")
            ms, cpu_ms = (time.perf_counter() - t0) * 1e3, (time.thread_time() - c0) * 1e3
            st = pauses.setdefault(info["generation"], [0, 0.0, 0.0, 0.0])
            st[0], st[1], st[2], st[3] = st[0] + 1, max(st[1], ms), st[2] + ms, max(st[3], cpu_ms)

    try:
        shutil.rmtree(SERVER_WORK, ignore_errors=True)
        SERVER_WORK.mkdir(parents=True)
        mgr, mgr_addr, ops_channel, ops, pb2, rest = manager_server(SERVER_WORK / "manager")
        seed_blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
        up = ops.CreateModel(pb2.CreateModelRequest(model_id="mlp-seeded", type="mlp", weights=seed_blob))
        check((up.version, up.state) == (1, "inactive"), f"the seeded MLP landed as {up.version} {up.state}")
        before = registry_snapshot()["counters"]
        trainer = TrainerServer(TrainerServerConfig(
            data_dir=str(SERVER_WORK / "trainer"), manager_address=mgr_addr, device=str(device),
            metrics_port=0, synchronous=False, gnn_epochs=gnn_epochs, mlp_batch_size=mlp_batch,
        ))
        trainer_addr = trainer.serve()
        served_at = {"trainer": time.perf_counter()}
        # the refresher and job worker poll only when asked here, and the
        # probe deltas flush once after each round: the reference's config
        # fields, set for a timed run
        cfg = SchedulerServerConfig(
            data_dir=str(SERVER_WORK / "scheduler"), hostname=SERVER_HOST, advertise_ip=SERVER_IP,
            manager_address=mgr_addr, trainer_address=trainer_addr, algorithm="ml", device=str(device),
            metrics_port=0, model_refresh_interval=3600.0, job_poll_interval=3600.0,
            topology_flush_threshold=hosts * probes + 1,
        )
        # the server builds its evaluator and scoring service from these names
        built = (sched_server.MLEvaluator, serving_mod.ScoringService)
        sched_server.MLEvaluator, serving_mod.ScoringService = _ServerRecordingEvaluator, _ServerRecordingService
        try:
            srv = SchedulerServer(cfg)
        finally:
            sched_server.MLEvaluator, serving_mod.ScoringService = built
        evaluator, service = srv.evaluator, srv.scoring_service
        check(isinstance(evaluator, _ServerRecordingEvaluator) and isinstance(service, _ServerRecordingService),
              "the server did not build the recording evaluator and service")
        addr = srv.serve()
        served_at["scheduler"] = time.perf_counter()
        reporters = {"scheduler": srv.telemetry_reporter, "trainer": trainer.telemetry_reporter}
        # each push: (time.monotonic() at its start, build_payload ms, whole push ms)
        pushes = {name: [] for name in reporters}
        payload_bytes = {name: [] for name in reporters}  # each payload's JSON size
        for name, rep in reporters.items():
            check(rep is not None and rep.interval == 15.0, f"the {name} server runs no reporter at 15 s")
            building = []

            def timed_build(build=rep.build_payload, sink=building, sizes=payload_bytes[name]):
                t0 = time.perf_counter()
                got = build()
                sink.append((time.perf_counter() - t0) * 1e3)
                sizes.append(len(json.dumps(got[0], default=str)))
                return got

            def timed_push(push=rep.push_once, log=pushes[name], built=building):
                t0, m0 = time.perf_counter(), time.monotonic()
                ok = push()
                log.append((m0, built.pop() if built else float("nan"), (time.perf_counter() - t0) * 1e3))
                return ok

            rep.build_payload, rep.push_once = timed_build, timed_push
        out = {"daemon_procs": procs}
        # the gate: an inactive upload is never installed; once activated,
        # the next poll installs it
        check(srv.model_refresher.loaded_version is None and not srv.model_refresher.refresh_once()
              and srv.model_refresher.loaded_version is None, "a poll installed the inactive seeded MLP")
        t0 = time.perf_counter()
        activate(ops, pb2, "mlp-seeded", 1)
        check(srv.model_refresher.refresh_once(), "the refresher did not install the activated seeded MLP")
        sync(device)
        out["seed_activation_to_install_ms"] = (time.perf_counter() - t0) * 1e3
        check(srv.model_refresher.loaded_version == ("mlp-seeded", 1), "the seeded MLP is not installed")
        check(service.model_kind() == "mlp", "the seeded MLP does not hold the serving slot")
        print(f"server[{device}]: the seeded MLP uploaded inactive, not installed by a poll; activated →"
              f" installed in {out['seed_activation_to_install_ms']:.1f} ms")
        check(srv.topology_engine.device.type == device.type, "the topology engine is not on the device")
        daemons.map("dial", [addr] * procs)
        gc.callbacks.append(on_gc)

        t0 = time.perf_counter()
        daemons.map("announce", list(range(hosts)))
        announce_s = time.perf_counter() - t0
        check(len(srv.resource.host_manager.all()) == hosts, "hosts lost in AnnounceHost")

        topology_rows, named, probe_s, snapshot_s = 0, [], 0.0, 0.0
        bounds = np.linspace(0, probes, probe_rounds + 1).astype(int)
        for r, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            # a round's probes are stamped a second apart, oldest first; a
            # later round re-probes the next slice of a host's peers and
            # reports only
            at_ns = time.time_ns() - (probe_rounds - r) * 10**9
            t0 = time.perf_counter()
            named += daemons.map("probes", [(i, int(lo), int(hi), at_ns, r == 0) for i in range(hosts)])
            srv.topology_engine.flush()
            sync(device)
            t1 = time.perf_counter()
            topology_rows += srv.networktopology.snapshot()
            probe_s, snapshot_s = probe_s + t1 - t0, snapshot_s + time.perf_counter() - t1
        stats = srv.topology_engine.stats()
        check(stats["edges"] == hosts * probes, f"edges lost in SyncProbes: {stats['edges']}")
        check(all(0 < n <= 5 for n in named[:hosts]), "SyncProbes named no probe targets")
        out.update(announce_host_per_s=hosts / announce_s, announce_s=announce_s, probe_ingest_s=probe_s,
                   snapshot_s=snapshot_s, edges=stats["edges"], topology_rows=topology_rows)
        print(
            f"server[{device}]: {hosts} hosts announced in {announce_s:.2f}s"
            f" ({out['announce_host_per_s']:.0f}/s) by {procs} daemon processes; {stats['edges']} probes"
            f" through SyncProbes in {probe_rounds} rounds, each with one engine flush, in {probe_s:.2f}s;"
            f" {topology_rows} topology rows in {probe_rounds} snapshots ({snapshot_s:.2f}s)"
        )

        seen = {}  # peer id → (response kind, parent ids, register-sent s, response s)

        def run(specs):
            got = daemons.map("peers", specs)
            for pid, kind, parents, t_reg, t_resp in got:
                seen[pid] = (kind, parents, t_reg, t_resp)
            return [g[0] for g in got]

        def decide_ms(pid):
            return (seen[pid][3] - seen[pid][2]) * 1e3

        seeds = [(t, 0, int(hosts_of[t][0]), True) for t in range(tasks)]
        children = [(t, k, int(hosts_of[t][k]), False) for k in range(1, peers) for t in range(tasks)]
        later = [(t, peers + k, int(hosts_of[t][peers + k]), False)
                 for k in range(per_task) for t in range(tasks)][:phase2]

        def check_decisions(pids, phase, warm):
            """The client's and the server's view of each decision → the
            decide_ms of those after the warm-up, and how many were served.
            A decision after the warm-up that the scoring service did not
            answer is a demotion; all of them are listed, then fail."""
            name = f"server[{device}] {phase}"
            walls, served, demoted = [], 0, []
            for n, pid in enumerate(pids):
                kind, parents, _, t_resp = seen[pid]
                rec = evaluator.decisions.get(pid)
                check(kind in ("normal_task", "need_back_to_source"), f"{name}: {pid} got {kind}")
                if kind == "need_back_to_source":
                    # legitimate: the peer demanded it, or no candidate
                    # survived the filter in any retry
                    check(srv.resource.peer_manager.load(pid).need_back_to_source or rec is None,
                          f"{name}: {pid} sent back to source with parents ranked")
                    continue
                # legal: peers of the same task whose register was sent
                # before this answer came back (one clock for every
                # process), not the child, none blocklisted (the daemons
                # block no parent here)
                check(parents and pid not in parents
                      and all(p[:8] == pid[:8] and p in seen and seen[p][2] < t_resp for p in parents),
                      f"{name}: {pid} got parents that are no legal candidates: {parents}")
                check(rec is not None and parents == rec["ranked"][: len(parents)],
                      f"{name}: {pid}'s parents are not the head of its ranking")
                if n < warm:
                    continue
                walls.append(decide_ms(pid))
                if rec["served"] is None:
                    demoted.append(pid)
                    continue
                _, _, scored, _ = rec["served"]
                scores, ranking = scored[0]
                check(np.isfinite(scores).all() and len(scores) == len(rec["candidates"]), f"{name}: scores")
                check(np.array_equal(ranking, wave.rank_order(scores, np.zeros(len(scores)))),
                      f"{name}: {pid}'s ranking is not rank_order of its scores")
                check([rec["candidates"][int(j)] for j in ranking] == rec["ranked"],
                      f"{name}: {pid}'s order is not its ranking")
                served += 1
            if demoted:
                near = [(round(m0, 3), round(b, 1), round(ms, 1)) for m0, b, ms in pushes["scheduler"]
                        if any(t - 3.0 <= m0 <= t for t, _ in service.errors)]
                print(f"{name}: {len(demoted)} decisions demoted below the serving rung, e.g."
                      f" {demoted[:5]}; the service raised: {service.errors[:5]}; the server's"
                      f" collections so far (generation: count, longest wall ms, total wall ms,"
                      f" longest thread ms): {pauses}; the scheduler's telemetry pushes started"
                      f" within 3 s before a serving timeout (monotonic s, build ms, push ms): {near}"
                      f" of {len(pushes['scheduler'])}")
            check(not demoted, f"{name}: {len(demoted)} decisions demoted after the warm-up")
            return walls, served

        def phase_stats(walls, wall_s, decisions, served, launches0, phase):
            launches = service.launches - launches0[0]
            calls = service.launch_calls - launches0[1]
            batch_ms = service.batch_ms[launches0[0] : service.launches] or [0.0]
            st = {
                "decisions": decisions, "served": served, "wall_s": wall_s,
                "decisions_per_s": decisions / wall_s,
                "decide_ms_p50": float(np.percentile(walls, 50)), "decide_ms_p99": float(np.percentile(walls, 99)),
                "launches": launches, "calls_per_launch": calls / launches if launches else 0.0,
                "batch_ms_p50": float(np.percentile(batch_ms, 50)), "batch_ms_p99": float(np.percentile(batch_ms, 99)),
                "batch_ms_max": float(max(batch_ms)),
            }
            print(
                f"server[{device}] {phase}: {decisions} decisions in {wall_s:.2f}s"
                f" ({st['decisions_per_s']:.1f}/s) at {concurrency} streams on the server's"
                f" {workers} gRPC workers; decide_ms p50={st['decide_ms_p50']:.2f}"
                f" p99={st['decide_ms_p99']:.2f} over {len(walls)} after the warm-up (register sent →"
                f" response); {served} served; {launches} scoring launches, {st['calls_per_launch']:.2f}"
                f" calls each, a launch's wall ms p50={st['batch_ms_p50']:.2f} p99={st['batch_ms_p99']:.2f}"
                f" max={st['batch_ms_max']:.2f} (the service's grace {service.cfg.service_grace_s * 1e3:.0f})"
            )
            return st

        # phase 1: the seeds go back to source, then the children
        t0 = time.perf_counter()
        run(seeds)
        check(all(seen[f"peer-{t:02d}-000"][0] == "need_back_to_source" for t in range(tasks)),
              "a seed peer was not sent back to source")
        l0 = (service.launches, service.launch_calls)
        warm = concurrency
        done = run(children[:warm])
        traced = children[warm : warm + 4 * concurrency]
        if device.type == "cuda":
            wall_ms, busy_ms = device_busy(lambda: done.extend(run(traced)))
            check(busy_ms is not None, f"server[{device}]: the traced decisions ran nothing on the card")
            out.update(traced_decisions=len(traced), traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
                       device_idle_share=1 - busy_ms / wall_ms)
            print(
                f"server[{device}]: traced {len(traced)} decisions of phase 1: {wall_ms:.1f} ms wall,"
                f" device busy {busy_ms:.2f} ms (idle share {out['device_idle_share']:.4f})"
            )
        else:
            done.extend(run(traced))
        done.extend(run(children[warm + len(traced) :]))
        phase1_s = time.perf_counter() - t0
        walls, served = check_decisions(done, "phase 1", warm)
        out["phase1"] = phase_stats(walls, phase1_s, len(done) + tasks, served, l0, "phase 1")
        out["phase1"]["warmup_decide_ms_max"] = max(decide_ms(p) for p in done[:warm])
        check(service.model_kind() == "mlp", "phase 1 was not served by the MLP")

        # upload → fits → CreateModel × 3 → install
        uploads0 = len(mgr.models.list())
        srv.storage.flush()
        records = Path(cfg.data_dir) / "records"
        blocks = sorted((records / "blocks").glob("download*.dfb"))
        labels = np.concatenate([wire.read_train_pairs(p).labels for p in blocks])
        gru_labels = np.concatenate([q.labels for p in blocks for q in wire.stream_gru_sequences(p)])
        upload_bytes = sum(p.stat().st_size for p in (records / "blocks").glob("*.dfb"))
        # the probe graph and config of the trainer's GNN fit, for the mean
        # predictor on the fit's own holdout
        fitted = []

        def recording_train_gnn(graph, config=None, **kw):
            fitted.append((graph, config or GNNFitConfig()))
            return train_gnn(graph, config=config, **kw)

        training_mod.train_gnn = recording_train_gnn
        try:
            t0 = time.perf_counter()
            check(srv.announcer.train_once(), "the announcer uploaded nothing")
            upload_s = time.perf_counter() - t0
            deadline = time.time() + 900
            while len(mgr.models.list()) < uploads0 + 3 and time.time() < deadline:
                time.sleep(0.05)
            round_s = time.perf_counter() - t0
        finally:
            training_mod.train_gnn = train_gnn
        check(len(mgr.models.list()) == uploads0 + 3, "the trainer sent no three CreateModel")
        ups = {}
        for t, f in (("mlp", mlp_model_id_v1), ("gnn", gnn_model_id_v1), ("gru", gru_model_id_v1)):
            row = mgr.models.get(f(SERVER_IP, SERVER_HOST), 1)
            check(row is not None and row.state == "inactive", f"the trained {t} did not land inactive: {row}")
            ups[t] = SimpleNamespace(model_id=row.model_id, version=row.version, type=row.type,
                                     evaluation=SimpleNamespace(**row.evaluation),
                                     weights=mgr.models.load_weights(row.model_id, row.version))
        # the live graph the refresher embeds for serving (rescored below)
        graph = build_probe_graph(records_to_columns(srv.networktopology.export_records()))
        check(len(fitted) == 1, f"the trainer ran {len(fitted)} GNN fits, not 1")
        # the GNN's holdout is the trainer's own split of the graph it fit
        # (its snapshots' edges, in their order — not the live graph's);
        # the MLP's and the GRU's mean predictors are over all their labels
        fit_graph, fit_cfg = fitted[0]
        _, eval_idx = _split_eval(len(fit_graph.edge_src), fit_cfg.eval_fraction, fit_cfg.seed)
        means = {"mlp": mean_mse(labels), "gnn": mean_mse(fit_graph.edge_rtt_log_ms[eval_idx]),
                 "gru": mean_mse(gru_labels)}
        for t, up in ups.items():
            check(up.type == t, f"the {t} upload has type {up.type}")
            print(f"server[{device}]: trained {t}: holdout mse={up.evaluation.mse:.5f}"
                  f" (mean predictor {means[t]:.5f})")
            check(np.isfinite(up.evaluation.mse) and up.evaluation.mse < means[t],
                  f"the {t} fit does not beat the mean predictor")
        r = srv.model_refresher
        check(not r.refresh_once() and r.loaded_version == ("mlp-seeded", 1) and r.loaded_gnn_version is None
              and r.loaded_gru_version is None, "a poll installed an inactive trained model")
        t0 = time.perf_counter()
        for t in ups:
            activate_over_rest(rest, ups[t].model_id, ups[t].version)
        check(r.refresh_once(), "the refresher installed nothing")
        sync(device)
        install_ms = (time.perf_counter() - t0) * 1e3
        for t, got in (("mlp", r.loaded_version), ("gnn", r.loaded_gnn_version), ("gru", r.loaded_gru_version)):
            want = (ups[t].model_id, ups[t].version)
            check(got == want, f"the refresher loaded {t} {got}, not the upload {want}")
        check(service.model_kind() == "gnn", "the trained GNN does not hold the serving slot")
        out.update(upload_mib=upload_bytes / 2**20, upload_s=upload_s, round_s=round_s, install_ms=install_ms,
                   download_pairs=len(labels),
                   mse={t: ups[t].evaluation.mse for t in ups}, mean_predictor_mse=means)
        print(
            f"server[{device}]: announcer → TrainerServer over gRPC: {out['upload_mib']:.2f} MiB of blocks"
            f" ({len(labels)} pairs, {topology_rows} topology rows) streamed in {upload_s:.2f}s;"
            f" round_s={round_s:.1f} (upload → three CreateModel, landed inactive); install_ms={install_ms:.1f}"
            f" (three REST activations → the next poll installed them)"
        )

        # phase 2: more children, on the trained GNN with the GRU filter
        l0 = (service.launches, service.launch_calls)
        t0 = time.perf_counter()
        done2 = run(later)
        phase2_s = time.perf_counter() - t0
        warm2 = min(concurrency, len(done2) // 4)
        walls, served = check_decisions(done2, "phase 2", warm2)
        out["phase2"] = phase_stats(walls, phase2_s, len(done2), served, l0, "phase 2")
        out["phase2"]["warmup_decide_ms_max"] = max(decide_ms(p) for p in done2[:warm2])
        check(service.model_kind() == "gnn", "phase 2 was not served by the GNN")
        check(len(evaluator._gru_verdicts) > 0, "is_bad_node never took the GRU branch")
        before1 = SERVER_BEFORE_TELEMETRY
        print(
            f"server[{device}] phase 1 beside the same leg before telemetry and /metrics (NVIDIA H100 80GB"
            f" HBM3, 700.00 W): {out['phase1']['decisions_per_s']:.1f}/s ({before1['decisions_per_s']}/s);"
            f" decide_ms p50 {out['phase1']['decide_ms_p50']:.1f} ({before1['decide_ms_p50']}),"
            f" p99 {out['phase1']['decide_ms_p99']:.1f} ({before1['decide_ms_p99']})"
        )

        # telemetry: one last push from each reporter after the last
        # decision, then the pushes, the manager's plane and the scrape ports
        n_peers = len(seeds) + len(children) + len(later)
        own = {
            "scheduler": {
                "dragonfly_scheduler_announce_peer_total{event=register_peer}": n_peers,
                "dragonfly_scheduler_announce_peer_total{event=download_peer_finished}": n_peers,
                "dragonfly_scheduler_sync_probes_total{kind=probe_started}": hosts,
                "dragonfly_scheduler_sync_probes_total{kind=probe_finished}": hosts * probe_rounds,
            },
            "trainer": {"dragonfly_trainer_train_total": 1},
        }
        servers = {"scheduler": srv, "trainer": trainer}
        out["telemetry"] = {}
        for name, rep in reporters.items():
            check(rep.push_once(), f"the {name} server's last push failed")
            leg_s = time.perf_counter() - served_at[name]
            held = plane_view(mgr.telemetry, name, rep.instance)
            floor = max(int(leg_s // rep.interval) - 1, 0)
            check(rep.failures == 0 and rep.pushes >= floor,
                  f"the {name} server pushed {rep.pushes} times with {rep.failures} failures in {leg_s:.1f}s"
                  f" (at least {floor} wanted, none failed)")
            sizes = payload_bytes[name]
            build_ms, push_ms = [b for _, b, _ in pushes[name]], [ms for _, _, ms in pushes[name]]
            st = {
                "pushes": rep.pushes, "failures": rep.failures, "leg_s": leg_s, "min_pushes": floor,
                "build_payload_ms_p50": float(np.percentile(build_ms, 50)),
                "build_payload_ms_max": max(build_ms),
                "push_ms_p50": float(np.percentile(push_ms, 50)), "push_ms_max": max(push_ms),
                "payload_bytes_p50": float(np.percentile(sizes, 50)), "payload_bytes_max": max(sizes),
                "payload_bytes_total": sum(sizes),
            }
            print(
                f"server[{device}]: {name} telemetry: {rep.pushes} pushes ({rep.failures} failed) in"
                f" {leg_s:.1f}s at {rep.interval:g} s (at least {floor} wanted); build_payload ms"
                f" p50={st['build_payload_ms_p50']:.3f} max={st['build_payload_ms_max']:.3f}, a whole push"
                f" p50={st['push_ms_p50']:.3f} max={st['push_ms_max']:.3f} ms; payload bytes"
                f" p50={st['payload_bytes_p50']:.0f} max={st['payload_bytes_max']} total"
                f" {st['payload_bytes_total']}"
            )
            st.update(scrape_checks(name, servers[name].metrics_addr, held, own[name], before))
            out["telemetry"][name] = st
        out["manager"] = manager_checks(mgr, mgr_addr, {(name, rep.instance) for name, rep in reporters.items()},
                                        rest)
        out["rest"] = rest.summary(f"server[{device}]")

        # every served call rescored on the CPU
        cpu = {"seeded": MLPScorer(deserialize_params_auto(seed_blob), device="cpu"),
               "trained": MLPScorer(deserialize_params_auto(ups["mlp"].weights), device="cpu"),
               "gnn": GNNScorer(deserialize_params_auto(ups["gnn"].weights), graph, device="cpu")}
        errs = {"mlp": 0.0, "gnn": 0.0, "gnn_f32": 0.0}
        phase1 = set(done)
        gnn_rows = ([], [], [])  # the GNN's served pairs' sources, destinations, scores
        for pid in done + done2:
            rec = evaluator.decisions.get(pid)
            if rec is None or rec["served"] is None:
                continue
            feats, pairs, scored, kind = rec["served"]
            if kind == "mlp":
                want = cpu["seeded" if pid in phase1 else "trained"].predict(feats)
            else:
                src, dst = [a for a, _ in pairs], [b for _, b in pairs]
                with gnn_head_like_the_card():
                    want = cpu["gnn"].predict_rtt_log_ms(src, dst)
                f32 = cpu["gnn"].predict_rtt_log_ms(src, dst)
                errs["gnn_f32"] = max(errs["gnn_f32"], float(np.abs(scored[0][0] - f32).max()))
                for rows, got in zip(gnn_rows, (src, dst, scored[0][0])):
                    rows.extend(got)
            errs[kind] = max(errs[kind], float(np.abs(scored[0][0] - want).max()))
        print(
            f"server[{device}]: served scores against the CPU: max|mlp - cpu|={errs['mlp']:.3g}"
            f" (tol {SCORE_TOL:g}) max|gnn - cpu(bf16 head)|={errs['gnn']:.3g} (tol {GNN_SCORE_TOL:g}),"
            f" against a float32 head {errs['gnn_f32']:.3g}"
        )
        if device.type == "cuda":
            out["gnn_stages"] = hold_served_gnn(f"server[{device}]", service._served[0]._scorer, cpu["gnn"],
                                                *gnn_rows)
        check(errs["mlp"] <= SCORE_TOL, "served MLP scores differ from the CPU")
        check(errs["gnn"] <= GNN_SCORE_TOL, "served GNN scores differ from the CPU")
        out.update(score_err=errs, gru_verdicts=len(evaluator._gru_verdicts),
                   gc_pauses={g: {"collections": c, "longest_ms": m, "total_ms": s, "longest_thread_ms": t}
                              for g, (c, m, s, t) in sorted(pauses.items())})
        print(f"server[{device}]: the server process's collections from the announces on"
              f" (generation: count, longest wall ms, total wall ms, longest thread ms): "
              + "; ".join(f"{g}: {c}, {m:.1f}, {s:.1f}, {t:.1f}" for g, (c, m, s, t) in sorted(pauses.items())))
        return out
    finally:
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        daemons.close()
        if srv is not None:
            srv.stop()
        if trainer is not None:
            trainer.stop()
        if ops_channel is not None:
            ops_channel.close()
        if mgr is not None:
            mgr.stop()
        shutil.rmtree(SERVER_WORK, ignore_errors=True)


DOWNLOAD_WORK = Path(__file__).resolve().parent / "build" / "download_leg"
# the burst: one seed peer and 7 peers, one process each, pulling one 1 GiB
# object at once (a node pool pulling an image layer or a model shard at a
# rollout); then an image of 4 layers of 64 MiB preheated through the job
# worker and pulled through one peer's registry proxy, and a fresh image of
# the same shape pulled by every peer at once, each through its own proxy
DOWNLOAD_PEERS = 7
DOWNLOAD_FILE_MIB = 1024
DOWNLOAD_LAYERS, DOWNLOAD_LAYER_MIB = 4, 64
DOWNLOAD_PROBE_INTERVAL_S = 2.0
IMAGE_PATH = "/v2/leg/app"  # the registry stand-in's repository
FRESH_IMAGE_PATH = "/v2/leg/fresh"  # the image no peer holds before its pull
# the proxy's one rule: layer blobs ride P2P, manifests go to the registry
PROXY_RULES = [{"regex": "/v2/.*/blobs/"}]
# then the object step (a training job writes a 256 MiB checkpoint or model
# shard through one peer's object-storage gateway with seed-on-write, the
# other peers load it at once, each through its own gateway) and the S3
# step (every peer dfgets a 256 MiB object from an S3 bucket at once)
DOWNLOAD_OBJECT_MIB = 256
DOWNLOAD_S3_MIB = 256
OBJECT_BUCKET, OBJECT_KEY = "leg", "shard-0"
S3_BUCKET, S3_KEY = "leg", "model-0.bin"
# the leg's S3 credentials: every daemon gets them in its environment, as
# a deployment's daemon set would; the stand-in refuses any other
S3_ACCESS_KEY, S3_SECRET_KEY = "AKIADOWNLOADLEG", "download-leg-secret"
_FLOW_BYTES = "dragonfly_flow_bytes_total"


def _send_file(handler, path: str, body: bool, sent: dict, lock) -> None:
    """Answer ``handler``'s request with the file at ``path`` (its
    ``Range``, if any, as a 206) and, when ``body``, send it through
    ``socket.sendfile``, adding the bytes sent to ``sent`` under the
    request's URL path."""
    import os
    import urllib.parse

    size = os.path.getsize(path)
    lo, hi, status = 0, size - 1, 200
    rng = handler.headers.get("Range")
    if rng:
        a, _, b = rng.removeprefix("bytes=").partition("-")
        lo, hi, status = int(a), min(int(b), size - 1) if b else size - 1, 206
    handler.send_response(status)
    handler.send_header("Content-Length", str(hi - lo + 1))
    handler.send_header("Accept-Ranges", "bytes")
    if status == 206:
        handler.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
    handler.end_headers()
    if not body:
        return
    handler.wfile.flush()
    with open(path, "rb") as f:
        n = handler.connection.sendfile(f, lo, hi - lo + 1)
    key = urllib.parse.urlsplit(handler.path).path
    with lock:
        sent[key] = sent.get(key, 0) + n


def _origin_process(conn, root):
    """The origin in its own interpreter: files under ``root`` served by
    URL path (HEAD, GET, ``Range``) through ``socket.sendfile``, counting
    the body bytes sent for each path; ``GET /_sent`` answers those counts
    as JSON. Sends its port over ``conn``, then serves until killed."""
    import http.server
    import os

    sent = {}
    lock = threading.Lock()

    class Origin(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _serve(self, body: bool):
            if self.path == "/_sent":
                with lock:
                    data = json.dumps(sent).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            path = os.path.join(root, self.path.lstrip("/"))
            if ".." in self.path or not os.path.isfile(path):
                self.send_error(404)
                return
            _send_file(self, path, body, sent, lock)

        def do_HEAD(self):
            self._serve(False)

        def do_GET(self):
            self._serve(True)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Origin)
    srv.daemon_threads = True
    conn.send(srv.server_address[1])
    conn.close()
    srv.serve_forever()


def _s3_process(conn, root, access_key):
    """An S3 stand-in in its own interpreter: the objects under ``root`` as
    ``<bucket>/<key>``, path-style. HEAD, GET with ``Range`` (``_send_file``,
    its bytes counted per path) and ListObjectsV2 (``GET
    /<bucket>?list-type=2&prefix=``). A request whose
    ``Authorization`` is not SigV4 with ``access_key``'s credential for the
    ``s3`` service gets 403, counted. ``GET /_sent`` (unsigned) answers
    {"sent": {path: bytes}, "refused": n}. Sends its port over ``conn``,
    then serves until killed."""
    import http.server
    import os
    import urllib.parse

    sent, refused = {}, [0]
    lock = threading.Lock()
    signed = re.compile(rf"^AWS4-HMAC-SHA256 Credential={re.escape(access_key)}/\d{{8}}/[^/]+/s3/aws4_request,"
                        r" SignedHeaders=[a-z0-9;-]+, Signature=[0-9a-f]{64}$")

    class S3(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _answer(self, status: int, data: bytes = b"") -> None:
            self.send_response(status)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _serve(self, body: bool):
            parts = urllib.parse.urlsplit(self.path)
            if parts.path == "/_sent":
                with lock:
                    data = json.dumps({"sent": sent, "refused": refused[0]}).encode()
                self._answer(200, data)
                return
            if not signed.match(self.headers.get("Authorization", "")):
                with lock:
                    refused[0] += 1
                self._answer(403, b"<Error><Code>AccessDenied</Code></Error>")
                return
            bucket, _, key = parts.path.lstrip("/").partition("/")
            query = urllib.parse.parse_qs(parts.query)
            if not key and "list-type" in query:
                prefix = query.get("prefix", [""])[0]
                base = os.path.join(root, bucket)
                keys = sorted(os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base) for f in fs)
                contents = "".join(f"<Contents><Key>{k}</Key></Contents>" for k in keys if k.startswith(prefix))
                self._answer(200, f'<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">{contents}'
                                  f"</ListBucketResult>".encode())
                return
            path = os.path.join(root, bucket, urllib.parse.unquote(key))
            if ".." in parts.path or not key or not os.path.isfile(path):
                self._answer(404, b"<Error><Code>NoSuchKey</Code></Error>")
                return
            _send_file(self, path, body, sent, lock)

        def do_HEAD(self):
            self._serve(False)

        def do_GET(self):
            self._serve(True)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), S3)
    srv.daemon_threads = True
    conn.send(srv.server_address[1])
    conn.close()
    srv.serve_forever()


def _seeded_file(path: Path, mib: int, rng: np.random.Generator) -> str:
    """``mib`` MiB of seeded bytes at ``path`` → their sha256."""
    path.parent.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256()
    with open(path, "wb") as f:
        for _ in range(mib // 64):
            chunk = rng.bytes(64 << 20)
            h.update(chunk)
            f.write(chunk)
        if mib % 64:
            chunk = rng.bytes((mib % 64) << 20)
            h.update(chunk)
            f.write(chunk)
    return h.hexdigest()


def _image(root: Path, layers: int, layer_mib: int, rng: np.random.Generator,
           path: str = IMAGE_PATH) -> "tuple[list[str], dict]":
    """A registry stand-in's files under ``root`` for the repository at
    ``path``: an OCI index (``manifests/v1``) over a ``linux/arm64`` and a
    ``linux/amd64`` manifest, the latter of ``layers`` seeded layers →
    (layer digests, digest → sha256)."""
    repo = root / path.lstrip("/")
    digests = []
    for i in range(layers):
        tmp = repo / "blobs" / f"layer-{i}"
        d = "sha256:" + _seeded_file(tmp, layer_mib, rng)
        tmp.rename(repo / "blobs" / d)
        digests.append(d)
    config = json.dumps({"architecture": "amd64", "os": "linux"}).encode()
    cfg_digest = "sha256:" + hashlib.sha256(config).hexdigest()
    (repo / "blobs" / cfg_digest).write_bytes(config)
    manifest = json.dumps({
        "schemaVersion": 2, "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "config": {"mediaType": "application/vnd.oci.image.config.v1+json", "digest": cfg_digest,
                   "size": len(config)},
        "layers": [{"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip", "digest": d,
                    "size": layer_mib << 20} for d in digests],
    }).encode()
    m_digest = "sha256:" + hashlib.sha256(manifest).hexdigest()
    (repo / "manifests").mkdir(parents=True)
    (repo / "manifests" / m_digest).write_bytes(manifest)
    index = {"schemaVersion": 2, "mediaType": "application/vnd.oci.image.index.v1+json", "manifests": [
        {"mediaType": "application/vnd.oci.image.manifest.v1+json", "digest": "sha256:" + "a" * 64,
         "size": 1, "platform": {"os": "linux", "architecture": "arm64"}},
        {"mediaType": "application/vnd.oci.image.manifest.v1+json", "digest": m_digest,
         "size": len(manifest), "platform": {"os": "linux", "architecture": "amd64"}},
    ]}
    (repo / "manifests" / "v1").write_text(json.dumps(index))
    return digests, {d: d.split(":", 1)[1] for d in digests}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _DaemonProcs:
    """The port's daemons, each ``python -m dragonfly2_torch.client.daemon``
    in its own interpreter (a deployment runs them so; the card's process
    holds a CUDA context, and the daemons see no card:
    ``CUDA_VISIBLE_DEVICES`` is empty), at ``DaemonConfig``'s defaults but
    for ``overrides``; each serves /metrics on a port of its own.
    ``start`` returns once every daemon printed its ``READY`` line. With
    ``module="dragonfly2_torch.scheduler"`` and ``card=True`` the processes
    are the port's scheduler binaries, which see the card."""

    def __init__(self, work: Path, module: str = "dragonfly2_torch.client.daemon", card: bool = False):
        self.work = work
        self.module = module
        self.card = card
        self.procs = {}  # name → (Popen, gRPC address, metrics address)

    def start(self, specs: "dict[str, dict]", timeout: float = 120.0, env: "dict | None" = None) -> None:
        """``env``: variables every daemon gets in its environment besides
        the script's own."""
        import os
        import selectors

        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent), **(env or {}))
        if not self.card:
            env["CUDA_VISIBLE_DEVICES"] = ""
        sel = selectors.DefaultSelector()
        for name, overrides in specs.items():
            metrics = _free_port()
            args = [sys.executable, "-m", self.module,
                    "--set", f"data_dir={self.work / name}", "--set", f"hostname={name}",
                    "--set", f"metrics_port={metrics}"]
            for k, v in overrides.items():
                args += ["--set", f"{k}={v}"]
            log = open(self.work / f"{name}.log", "w")
            proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=log, text=True,
                                    cwd=str(Path(__file__).resolve().parent), env=env)
            log.close()
            self.procs[name] = (proc, None, f"127.0.0.1:{metrics}")
            sel.register(proc.stdout, selectors.EVENT_READ, name)
        waiting = set(specs)
        deadline = time.monotonic() + timeout
        while waiting:
            left = deadline - time.monotonic()
            check(left > 0, f"daemons {sorted(waiting)} not ready in {timeout:.0f} s")
            for key, _ in sel.select(left):
                name = key.data
                # the runner prints its address lines (METRICS, GATEWAY)
                # and READY back to back once the daemon is up, and the
                # text buffer may take them in one read: read to READY
                while not (line := key.fileobj.readline()).startswith("READY "):
                    if not line:
                        sel.unregister(key.fileobj)
                        tail = (self.work / f"{name}.log").read_text()[-2000:]
                        check(False, f"{name} exited before READY:\\n{tail}")
                proc, _, metrics = self.procs[name]
                self.procs[name] = (proc, line.split()[2], metrics)
                sel.unregister(key.fileobj)
                waiting.discard(name)

    def address(self, name: str) -> str:
        return self.procs[name][1]

    def counts(self, name: str, metric: str, label: str = "", **where: str) -> "dict[str, float]":
        """The daemon's samples of ``metric`` from its /metrics whose labels
        hold ``where``, by the value of ``label`` (``""`` for an unlabelled
        series)."""
        status, _, body, _ = http_get(f"http://{self.procs[name][2]}/metrics")
        check(status == 200, f"daemon {name}: /metrics answered {status}")
        out = {}
        for line in body.decode().splitlines():
            m = _SAMPLE.match(line)
            if m and m.group(1) == metric:
                labels = dict(_LABEL.findall(m.group(2) or ""))
                if all(labels.get(k) == v for k, v in where.items()):
                    out[labels.get(label, "")] = float(m.group(3))
        return out

    def traffic(self, name: str) -> "dict[str, float]":
        """Piece bytes the daemon wrote, by traffic type, from its /metrics."""
        return self.counts(name, "dragonfly_daemon_piece_traffic_bytes_total", "traffic_type")

    def events(self, name: str, kind: str) -> list:
        """The daemon's flight-recorder events of type ``kind``, from its
        /debug/ring."""
        return [e for ring in self.debug(name, "/debug/ring")["rings"].values() for e in ring if e["type"] == kind]

    def debug(self, name: str, path: str) -> dict:
        """The JSON a process's /debug endpoint at ``path`` answers."""
        status, _, body, _ = http_get(f"http://{self.procs[name][2]}{path}")
        check(status == 200, f"{name}: {path} answered {status}")
        return json.loads(body)

    def kill(self, name: str, sig) -> None:
        """Send ``sig`` to one process (a real signal: SIGKILL leaves it no
        last word)."""
        self.procs[name][0].send_signal(sig)

    def stop(self) -> None:
        import signal

        for proc, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc, _, _ in self.procs.values():
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()


_PROXY_TOTAL = "dragonfly_daemon_proxy_request_total"


def _proxy_pull(proxy: str, base: str, repo: str) -> dict:
    """Pull the image at ``base`` + ``repo`` as a container runtime does,
    through a daemon's registry proxy at ``proxy`` (``host:port``), on one
    keep-alive connection: the index, the ``linux/amd64`` manifest, then
    every layer in order, each hashed as it streams → {"wall_s", "layers":
    {digest: sha256}, "via_p2p": [header per layer], "task_ids": [...]}."""
    import http.client

    host, port = proxy.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=300)

    def get(path: str):
        conn.request("GET", f"{base}{repo}{path}")
        resp = conn.getresponse()
        if resp.status != 200:
            check(False, f"the proxy at {proxy} answered {resp.status} for {repo}{path}: {resp.read()[:200]!r}")
        return resp

    try:
        t = time.perf_counter()
        index = json.loads(get("/manifests/v1").read())
        amd64 = next(m["digest"] for m in index["manifests"]
                     if (m["platform"]["os"], m["platform"]["architecture"]) == ("linux", "amd64"))
        manifest = json.loads(get(f"/manifests/{amd64}").read())
        out = {"layers": {}, "via_p2p": [], "task_ids": []}
        for layer in manifest["layers"]:
            resp = get(f"/blobs/{layer['digest']}")
            h = hashlib.sha256()
            while chunk := resp.read(1 << 20):
                h.update(chunk)
            out["layers"][layer["digest"]] = h.hexdigest()
            out["via_p2p"].append(resp.getheader("X-Dragonfly-Via-P2P"))
            out["task_ids"].append(resp.getheader("X-Dragonfly-Task-Id", ""))
        out["wall_s"] = time.perf_counter() - t
        return out
    finally:
        conn.close()


def _object_get(gateway: str, bucket: str, key: str) -> dict:
    """GET an object through a daemon's object-storage gateway at
    ``gateway`` (``host:port``), hashed as it streams, as a node loading a
    shard reads it → {"wall_s", "sha256", "bytes", "via_p2p", "task_id"}."""
    import http.client
    import urllib.parse

    host, port = gateway.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        t = time.perf_counter()
        conn.request("GET", f"/buckets/{bucket}/objects/{urllib.parse.quote(key)}")
        resp = conn.getresponse()
        if resp.status != 200:
            check(False, f"the gateway at {gateway} answered {resp.status} for {bucket}/{key}: {resp.read()[:200]!r}")
        h, n = hashlib.sha256(), 0
        while chunk := resp.read(1 << 20):
            h.update(chunk)
            n += len(chunk)
        return {"wall_s": time.perf_counter() - t, "sha256": h.hexdigest(), "bytes": n,
                "via_p2p": resp.getheader("X-Dragonfly-Via-P2P"),
                "task_id": resp.getheader("X-Dragonfly-Task-Id", "")}
    finally:
        conn.close()


def _sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 << 20):
            h.update(chunk)
    return h.hexdigest()


# the download leg's load-generator step: requests per drive mode, over
# so many connections, each a fresh file of so many MiB
STRESS_RUN_REQUESTS, STRESS_RUN_CONNECTIONS, STRESS_RUN_MIB = 16, 4, 2


def stress_run_step(device, files: Path, base: str, daemon: str, proxy: str, seed: int) -> dict:
    """``tools.stress.run`` through ``daemon``'s gRPC ``Download`` and then
    through ``proxy`` (a ``/v2/…/blobs/`` path, which the proxy's rule sends
    through the swarm): ``STRESS_RUN_REQUESTS`` requests over
    ``STRESS_RUN_CONNECTIONS`` connections, each a task of its own of
    ``STRESS_RUN_MIB`` MiB that the origin serves from ``files``. Every
    request must succeed with all its bytes; rps and the latency
    percentiles are printed."""
    from dragonfly2_torch.tools import stress

    import os

    rng = np.random.default_rng(seed + 4)
    # a URL is a task: one seeded file a mode, under a name for every
    # ``{i}`` a worker can reach (worker k takes k, k + c, k + 2c, …, and
    # the requests may pass the budget by one a connection)
    for mode in ("daemon", "proxy"):
        blobs = files / "v2" / f"stress-{mode}" / "blobs"
        _seeded_file(blobs / "seeded", STRESS_RUN_MIB, rng)
        for i in range(STRESS_RUN_CONNECTIONS * (STRESS_RUN_REQUESTS + STRESS_RUN_CONNECTIONS)):
            os.symlink("seeded", blobs / f"sha256:{i}")
    runs = {}
    for mode, target in (("daemon", daemon), ("proxy", proxy)):
        got = stress.run(f"{base}/v2/stress-{mode}/blobs/sha256:{{i}}", connections=STRESS_RUN_CONNECTIONS,
                         requests=STRESS_RUN_REQUESTS, **{mode: target})
        runs[mode] = got
        lat = got["latency_s"]
        print(f"download[{device}]: stress.run --{mode}: {got['requests']} requests of {STRESS_RUN_MIB} MiB over"
              f" {STRESS_RUN_CONNECTIONS} connections in {got['wall_s']} s, {got['rps']} rps,"
              f" {got['throughput_mb_s']} MB/s; latency p50 {lat['p50']} p99 {lat['p99']} max {lat['max']} s;"
              f" {got['failures']} failed {got['errors']}")
        check(got["requests"] >= STRESS_RUN_REQUESTS and got["failures"] == 0
              and got["bytes"] == got["requests"] * (STRESS_RUN_MIB << 20),
              f"download[{device}]: stress.run --{mode} lost requests or bytes: {got}")
    return runs


def download_leg(
    device, peers=DOWNLOAD_PEERS, file_mib=DOWNLOAD_FILE_MIB, piece_length=0,
    layers=DOWNLOAD_LAYERS, layer_mib=DOWNLOAD_LAYER_MIB, probe_interval=DOWNLOAD_PROBE_INTERVAL_S,
    object_mib=DOWNLOAD_OBJECT_MIB, s3_mib=DOWNLOAD_S3_MIB, seed=0,
) -> dict:
    """The P2P download path end to end: the port's ``ManagerServer`` as
    shipped (``manager_server``), the port's ``SchedulerServer``
    (``algorithm="ml"`` on ``device``, a seeded MLP ``[19, 128, 128, 1]``
    uploaded inactive, which a poll must not install, then activated with
    ``UpdateModel`` and installed by the refresher) and the port's daemons
    — one seed peer (``host_type="super"``) and ``peers`` peers, each
    ``python -m dragonfly2_torch.client.daemon`` in its own interpreter at
    ``DaemonConfig``'s defaults (pieces from ``compute_piece_length``
    unless ``piece_length``) but a ``probe_interval`` of ``probe_interval``
    s, whose probes reach the topology engine through ``SyncProbes``. The
    daemons have no static scheduler list: each finds the scheduler
    through the manager (``manager_address``, ``DaemonDynconfig``), and the
    seed peer registers there with ``UpdateSeedPeer``. The manager holds a
    second scheduler cluster, scoped to another IDC, with a scheduler of
    its own on a closed port (the cluster settings an operator makes
    through the console, sent to the manager's REST front: a ``PATCH`` of
    the default cluster's scopes and a ``POST`` of the decoy): the searcher
    must keep it from the daemons, and ``ListSchedulers`` for the daemons'
    address must read back the one live scheduler before the burst. An origin in its own process
    serves a ``file_mib`` MiB file made from ``seed`` and counts its bytes.
    Traffic: every peer ``dfget``s the file at once (the burst); ``dfcache``
    stats and exports the task on one peer; a ``POST /oapi/v1/jobs`` on the
    manager's REST front, under a personal access token of an admin user
    minted there (signup, promotion, ``POST
    /api/v1/personal-access-tokens``), preheats an image (an OCI index →
    its ``linux/amd64`` manifest of ``layers`` layers of ``layer_mib``
    MiB) through the scheduler's job
    worker, which resolves the manifest with the port's source client and
    has the seed peer fetch every layer; then one peer ``dfget``s a layer.
    Every daemon serves its registry proxy (``proxy_port``, one rule:
    ``PROXY_RULES``, layer blobs through P2P). A peer that holds none of
    the preheated image pulls it through its own proxy (the index, the
    ``linux/amd64`` manifest, every layer); then every peer pulls at once,
    each through its own proxy, a fresh image of the same shape made from
    ``seed + 1`` (a node pool pulling a new image).

    Every daemon also serves its object-storage gateway
    (``object_storage_port``) over one ``object_storage_dir`` (the shared
    NFS/S3 stand-in), and has ``DF_S3_ACCESS_KEY``, ``DF_S3_SECRET_KEY``
    and ``DF_S3_ENDPOINT`` in its environment, as a deployment's daemon set
    would. The object step: one peer runs ``python -m
    dragonfly2_torch.client.dfstore mb`` and ``cp`` of an ``object_mib`` MiB
    object made from ``seed + 2`` into ``df://leg/shard-0`` through its own
    gateway with seed-on-write (a training job writing a model shard); once
    the scheduler holds the writer's import, every other peer GETs it at
    once through its own gateway (a pool of nodes loading the shard), and
    one reader runs a ranged ``cp`` of the middle third. The S3 step: an S3
    stand-in in its own process (``_s3_process``: path-style HEAD, GET with
    ``Range``, ListObjectsV2; 403 to any request not signed with the leg's
    key) holds an ``s3_mib`` MiB object made from ``seed + 3``; the leg
    lists the bucket through the port's S3 client, then every peer
    ``dfget``s ``s3://leg/model-0.bin`` at once.

    Checks: every output's sha256 is the origin's; every decision was
    served by the card's ``MLPScorer`` (``model_kind()`` ``mlp``, no
    demotion below the ``serving`` rung); origin egress below ``peers + 1``
    times the file; at least one peer took ≥ 90 % of its bytes from peers;
    at least ``peers`` download records written; the engine holds every
    probed pair; the preheated layer's pull cost the origin 0 bytes. Of the
    proxy pulls: every layer's sha256 is the origin's; the preheated
    image's layers cost the origin 0 bytes and rode the preheat's tasks;
    the fresh image's blob egress is below ``peers + 1`` times the image;
    every blob request rode P2P (the daemons' ``route="p2p"`` counts, no
    shed, no ``daemon.proxy_fallback`` event) and every manifest request
    went direct. Of the object step: every reader's sha256 is the written
    bytes' and the range's its slice's; the readers' daemons account 0
    ``origin`` bytes on the ``object`` plane (``flow_bytes_total`` from
    their /metrics); no ``daemon.object_fallback`` in any daemon's
    /debug/ring; every decision of the step (the object's task among them)
    served by the card's MLP, none demoted. Of the S3 step: the listing
    holds the object; every output's sha256 is the stand-in's; the
    stand-in's egress below ``peers + 1`` times the object; no request
    refused with 403; every decision served by the card's MLP, none
    demoted."""
    import multiprocessing
    import urllib.request

    from dragonfly2_torch.client import dfcache, dfget, source
    from dragonfly2_torch.manager.auth import _hash_password
    from dragonfly2_torch.scheduler import server as sched_server
    from dragonfly2_torch.scheduler import serving as serving_mod
    from dragonfly2_torch.scheduler.server import SchedulerServer, SchedulerServerConfig

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    names = ["seed"] + [f"peer-{i}" for i in range(peers)]
    out = {"peers": peers, "file_mib": file_mib}
    procs = _DaemonProcs(DOWNLOAD_WORK / "daemons")
    origin = s3 = mgr = ops_channel = srv = None
    decide_ms, log = [], []

    class _Evaluator(_ServerRecordingEvaluator):
        """The recording evaluator, keeping every decision in order with
        its child's task."""

        def evaluate_parents(self, parents, child, total_piece_count):
            ranked = super().evaluate_parents(parents, child, total_piece_count)
            log.append(dict(self.decisions[child.id], task=child.task.id))
            return ranked

    try:
        t0 = time.perf_counter()
        shutil.rmtree(DOWNLOAD_WORK, ignore_errors=True)
        (DOWNLOAD_WORK / "daemons").mkdir(parents=True)
        files = DOWNLOAD_WORK / "origin"
        file_sha = _seeded_file(files / "blob.bin", file_mib, rng)
        digests, layer_sha = _image(files, layers, layer_mib, rng)
        _, fresh_sha = _image(files, layers, layer_mib, np.random.default_rng(seed + 1), path=FRESH_IMAGE_PATH)
        ctx = multiprocessing.get_context("spawn")
        here, there = ctx.Pipe()
        origin = ctx.Process(target=_origin_process, args=(there, str(files)), daemon=True)
        origin.start()
        there.close()
        base = f"http://127.0.0.1:{here.recv()}"
        here.close()
        s3_root = DOWNLOAD_WORK / "s3"
        s3_sha = _seeded_file(s3_root / S3_BUCKET / S3_KEY, s3_mib, np.random.default_rng(seed + 3))
        here, there = ctx.Pipe()
        s3 = ctx.Process(target=_s3_process, args=(there, str(s3_root), S3_ACCESS_KEY), daemon=True)
        s3.start()
        there.close()
        s3_endpoint = f"http://127.0.0.1:{here.recv()}"
        here.close()
        objects_dir = DOWNLOAD_WORK / "objects"  # every gateway's backend
        object_src = DOWNLOAD_WORK / "object.bin"
        object_sha = _seeded_file(object_src, object_mib, np.random.default_rng(seed + 2))

        def sent() -> dict:
            with urllib.request.urlopen(f"{base}/_sent", timeout=30) as r:
                return json.loads(r.read())

        mgr, mgr_addr, ops_channel, ops, pb2, rest = manager_server(DOWNLOAD_WORK / "manager")
        # the operator's cluster settings, through the REST front: the
        # default cluster takes the loopback's peers; a decoy cluster in
        # another IDC has a scheduler on a closed loopback port that no
        # daemon may be handed (it registers over gRPC, as a scheduler does)
        default_id = mgr.service.default_cluster_id
        scoped = rest.call("PATCH", f"/api/v1/scheduler-clusters/{default_id}",
                           {"scopes": {"cidrs": ["127.0.0.0/8"]}}, route="/api/v1/scheduler-clusters/:id")
        check(json.loads(scoped["scopes"]) == {"cidrs": ["127.0.0.0/8"]}, f"the default cluster's scopes: {scoped}")
        decoy = rest.call("POST", "/api/v1/scheduler-clusters",
                          {"name": "decoy", "scopes": {"idc": "decoy-idc"}})["id"]
        ops.UpdateScheduler(pb2.UpdateSchedulerRequest(hostname="decoy", ip="127.0.0.1", port=_free_port(),
                                                       idc="decoy-idc", scheduler_cluster_id=decoy))
        blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
        up = ops.CreateModel(pb2.CreateModelRequest(model_id="mlp-seeded", type="mlp", weights=blob))
        check((up.version, up.state) == (1, "inactive"), f"the seeded MLP landed as {up.version} {up.state}")
        cfg = SchedulerServerConfig(
            data_dir=str(DOWNLOAD_WORK / "scheduler"), manager_address=mgr_addr, algorithm="ml",
            device=str(device), model_refresh_interval=3600.0, job_poll_interval=3600.0,
            seed_peer_enabled=True,
        )
        built = (sched_server.MLEvaluator, serving_mod.ScoringService)
        sched_server.MLEvaluator, serving_mod.ScoringService = _Evaluator, _ServerRecordingService
        try:
            srv = SchedulerServer(cfg)
        finally:
            sched_server.MLEvaluator, serving_mod.ScoringService = built
        evaluator, service = srv.evaluator, srv.scoring_service
        schedule = srv.scheduling.schedule_candidate_parents

        def timed_schedule(peer, blocklist=None, cancelled=None):
            t = time.perf_counter()
            try:
                return schedule(peer, blocklist, cancelled)
            finally:
                decide_ms.append((time.perf_counter() - t) * 1e3)

        srv.scheduling.schedule_candidate_parents = timed_schedule
        addr = srv.serve()
        check(srv.model_refresher.loaded_version is None and not srv.model_refresher.refresh_once(),
              "a poll installed the inactive seeded MLP")
        t1 = time.perf_counter()
        activate(ops, pb2, "mlp-seeded", 1)
        check(srv.model_refresher.refresh_once(), "the refresher did not install the activated seeded MLP")
        sync(device)
        out["activation_to_install_ms"] = (time.perf_counter() - t1) * 1e3
        check(srv.model_refresher.loaded_version == ("mlp-seeded", 1), "the seeded MLP is not installed")
        served = service._served[0]
        check(service.model_kind() == "mlp" and isinstance(served._scorer, MLPScorer)
              and served._scorer.device.type == device.type,
              f"the serving slot holds {service.model_kind()!r}, not the MLP on {device}")
        check(srv.topology_engine.device.type == device.type, "the topology engine is not on the device")
        out["setup_s"] = time.perf_counter() - t0
        print(f"download[{device}]: the seeded MLP uploaded inactive, not installed by a poll; activated →"
              f" installed in {out['activation_to_install_ms']:.1f} ms")

        t0 = time.perf_counter()
        # no static scheduler list ('' is YAML's empty string on the command line)
        common = {"scheduler_address": "''", "manager_address": mgr_addr, "probe_interval": probe_interval,
                  "proxy_rules": json.dumps(PROXY_RULES)}
        if piece_length:
            common["piece_length"] = piece_length
        proxies = {n: f"127.0.0.1:{_free_port()}" for n in names}
        gateways = {n: f"127.0.0.1:{_free_port()}" for n in names}
        procs.start({n: dict(common, host_type="super" if n == "seed" else "normal",
                             proxy_port=proxies[n].rsplit(":", 1)[1],
                             object_storage_port=gateways[n].rsplit(":", 1)[1],
                             object_storage_dir=str(objects_dir)) for n in names},
                    env={"DF_S3_ACCESS_KEY": S3_ACCESS_KEY, "DF_S3_SECRET_KEY": S3_SECRET_KEY,
                         "DF_S3_ENDPOINT": s3_endpoint})
        while len(srv.resource.host_manager.all()) < len(names):
            check(time.perf_counter() - t0 < 60, "the daemons' hosts were not all announced")
            time.sleep(0.05)
        out["daemons_up_s"] = time.perf_counter() - t0
        check(len(srv.seed_client.seed_hosts()) == 1, "the scheduler sees no seed peer")
        # every daemon's first probe round, before the traffic
        while len({k.split(":")[1] for k in srv.kvstore.scan_iter("networktopology:*")}) < len(names):
            check(time.perf_counter() - t0 < 60 + 5 * probe_interval, "a daemon never probed")
            time.sleep(0.05)
        out["probed_s"] = time.perf_counter() - t0
        print(f"download[{device}]: {len(names)} daemons up in {out['daemons_up_s']:.2f} s,"
              f" each probed by {out['probed_s']:.2f} s")
        # what the manager holds before the burst: the one live scheduler
        # for the daemons' address (the searcher's pick of clusters), the
        # decoy only for its own IDC, and the seed peer
        listed = ops.ListSchedulers(pb2.ListSchedulersRequest(ip="127.0.0.1"))
        check([(s.ip, s.port, s.scheduler_cluster_id) for s in listed.schedulers]
              == [("127.0.0.1", int(addr.rsplit(":", 1)[1]), mgr.service.default_cluster_id)],
              f"download[{device}]: ListSchedulers for the daemons gave {listed}")
        elsewhere = ops.ListSchedulers(pb2.ListSchedulersRequest(idc="decoy-idc"))
        check([s.hostname for s in elsewhere.schedulers] == ["decoy"],
              f"download[{device}]: ListSchedulers for the decoy IDC gave {elsewhere}")
        seeds = mgr.db.query("SELECT hostname, type, state, port FROM seed_peers")
        check([(r["hostname"], r["type"], r["state"]) for r in seeds] == [("seed", "super", "active")]
              and f"127.0.0.1:{seeds[0]['port']}" == procs.address("seed"),
              f"download[{device}]: the manager's seed peers are {seeds}")
        out["manager_schedulers"] = len(listed.schedulers)
        print(f"download[{device}]: the daemons found the scheduler through the manager; ListSchedulers"
              f" gives {addr} for them and the decoy only for its IDC; the seed peer is registered")

        # the burst: every peer dfgets the file at once
        url = f"{base}/blob.bin"
        outputs = {n: DOWNLOAD_WORK / "daemons" / f"{n}.out" for n in names[1:]}
        walls = {}
        launches0 = (service.launches, service.launch_calls)
        del decide_ms[:], log[:]

        def pull(name):
            t = time.perf_counter()
            dfget.download(procs.address(name), url, str(outputs[name]))
            walls[name] = time.perf_counter() - t

        def burst():
            t = time.perf_counter()
            with ThreadPoolExecutor(peers) as pool:
                list(pool.map(pull, names[1:]))
            walls["burst"] = time.perf_counter() - t

        if device.type == "cuda":
            # the profiler's own start and stop stay outside the burst's wall
            wall_ms, busy_ms = device_busy(burst)
            check(busy_ms is not None, f"download[{device}]: the burst ran nothing on the card")
            out.update(device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms)
        else:
            burst()
        burst_s = walls.pop("burst")
        with ThreadPoolExecutor(peers) as pool:
            shas = dict(zip(names[1:], pool.map(lambda n: _sha256_file(outputs[n]), names[1:])))
        for n, sha in shas.items():
            check(sha == file_sha, f"download[{device}]: {n}'s output is not the origin's bytes")
        size = file_mib << 20
        egress = sent().get("/blob.bin", 0)
        traffic = {n: procs.traffic(n) for n in names[1:]}
        from_peers = {n: t.get("remote_peer", 0.0) / max(sum(t.values()), 1.0) for n, t in traffic.items()}
        launches = service.launches - launches0[0]
        calls = service.launch_calls - launches0[1]
        demoted = [r["candidates"] for r in log if r["served"] is None]
        wall_list = sorted(walls.values())
        out["burst"] = {
            "wall_s": burst_s, "peer_wall_s": walls, "peer_wall_p50_s": float(np.percentile(wall_list, 50)),
            "peer_wall_max_s": wall_list[-1], "aggregate_mib_per_s": peers * file_mib / burst_s,
            "origin_egress_x": egress / size, "from_peers_share": {n: round(v, 6) for n, v in from_peers.items()},
            "peer_bytes_share": sum(t.get("remote_peer", 0.0) for t in traffic.values())
            / max(sum(sum(t.values()) for t in traffic.values()), 1.0),
            "decisions": len(decide_ms), "scored": len(log),
            "decide_ms_p50": float(np.percentile(decide_ms, 50)) if decide_ms else 0.0,
            "decide_ms_p99": float(np.percentile(decide_ms, 99)) if decide_ms else 0.0,
            "candidates_max": max((len(r["candidates"]) for r in log), default=0),
            "launches": launches, "calls_per_launch": calls / launches if launches else 0.0,
            "rung": evaluator._rung, "demoted": len(demoted), "kind": service.model_kind(),
        }
        b = out["burst"]
        print(
            f"download[{device}]: burst of {peers} × {file_mib} MiB in {burst_s:.2f} s"
            f" ({b['aggregate_mib_per_s']:.1f} MiB/s); peer wall p50 {b['peer_wall_p50_s']:.2f} s,"
            f" max {b['peer_wall_max_s']:.2f} s; origin egress {b['origin_egress_x']:.3f}× the file;"
            f" {b['peer_bytes_share']:.4f} of piece bytes from peers (per peer {b['from_peers_share']});"
            f" {b['decisions']} decisions ({b['scored']} scored, ≤ {b['candidates_max']} candidates),"
            f" decide_ms p50 {b['decide_ms_p50']:.2f} p99 {b['decide_ms_p99']:.2f}; {launches} scoring"
            f" launches, {b['calls_per_launch']:.2f} calls each; rung {b['rung']!r}, {len(demoted)} demoted"
            + (f"; device idle share {out['device_idle_share']:.4f}" if "device_idle_share" in out else "")
        )
        check(b["scored"] > 0 and b["rung"] == "serving" and not demoted and b["kind"] == "mlp",
              f"download[{device}]: decisions not all served by the MLP: {b}")
        check(egress < (peers + 1) * size, f"download[{device}]: origin egress {egress} ≥ {peers + 1}× the file")
        check(max(from_peers.values()) >= 0.9, f"download[{device}]: no peer took 90% from peers: {from_peers}")

        # dfcache on one peer: stat, then export the task
        peer0 = names[1]
        check(dfcache.stat(procs.address(peer0), url), "dfcache stat does not find the task")
        exported = DOWNLOAD_WORK / "daemons" / "exported.bin"
        dfcache.export_file(procs.address(peer0), url, str(exported), local_only=True)
        check(_sha256_file(exported) == file_sha, "dfcache export is not the origin's bytes")

        # image preheat through the job worker, then one peer pulls a layer;
        # the job goes in over the open API under a personal access token
        # of an admin user, minted over REST
        user = rest.call("POST", "/api/v1/users/signup", {"name": "preheater", "password": secrets.token_hex(8)},
                         token="")
        # what the signup's password hash (PBKDF2-SHA256, 100,000 rounds)
        # costs alone in this process, beside the request's wall
        t = time.perf_counter()
        _hash_password("leg", secrets.token_hex(16))
        out["password_hash_ms"] = (time.perf_counter() - t) * 1e3
        rest.call("PUT", f"/api/v1/users/{user['id']}/roles/admin", {}, route="/api/v1/users/:id/roles/admin")
        pat = rest.call("POST", "/api/v1/personal-access-tokens", {"user_id": user["id"], "name": "preheat"})
        before = sent()
        t0 = time.perf_counter()
        job = rest.call("POST", "/oapi/v1/jobs", {"type": "preheat", "args": {
            "type": "image", "url": f"{base}{IMAGE_PATH}/manifests/v1", "platform": "linux/amd64"}},
            token=pat["token"])
        check(job["scheduler_cluster_id"] == default_id, f"the preheat job went to cluster {job}")
        check(srv.job_worker.poll_once() == 1, "the job worker leased no job")
        job = rest.call("GET", f"/oapi/v1/jobs/{job['id']}", token=pat["token"], route="/oapi/v1/jobs/:id")
        state, result = job["state"], json.loads(job["result"])
        check(state == "succeeded" and result.get("layers") == layers and result.get("count") == layers,
              f"the image preheat job: {state} {result}")
        seed_host = next(h.id for h in srv.resource.host_manager.all() if h.hostname == "seed")

        def seeded():
            done = {p.task.id for p in srv.resource.peer_manager.all()
                    if p.host.id == seed_host and p.fsm.is_state(res.PEER_STATE_SUCCEEDED)}
            return set(result["triggered"]) <= done

        while not seeded():
            check(time.perf_counter() - t0 < 300, "the seed peer did not fetch every layer")
            time.sleep(0.05)
        preheat_s = time.perf_counter() - t0
        layer_url = f"{base}{IMAGE_PATH}/blobs/{digests[0]}"
        mid = sent()
        layer_out = DOWNLOAD_WORK / "daemons" / "layer.out"
        dfget.download(procs.address(peer0), layer_url, str(layer_out))
        check(_sha256_file(layer_out) == layer_sha[digests[0]], "the layer pull is not the registry's bytes")
        after = sent()
        layer_path = f"{IMAGE_PATH}/blobs/{digests[0]}"
        out["preheat"] = {
            "seconds": preheat_s, "layers": layers,
            "seed_origin_bytes": sum(after.get(k, 0) - before.get(k, 0) for k in after if "/blobs/" in k
                                     ) - (after.get(layer_path, 0) - mid.get(layer_path, 0)),
            "layer_pull_origin_bytes": after.get(layer_path, 0) - mid.get(layer_path, 0),
        }
        print(f"download[{device}]: image preheat of {layers} × {layer_mib} MiB in {preheat_s:.2f} s;"
              f" the layer pull cost the origin {out['preheat']['layer_pull_origin_bytes']} bytes")
        check(out["preheat"]["layer_pull_origin_bytes"] == 0, "the preheated layer's pull reached the origin")
        check(not [r for r in log if r["served"] is None], "a decision after the burst was demoted")
        out["rest"] = rest.summary(f"download[{device}]")
        print(f"download[{device}]: the signup's password hash alone took {out['password_hash_ms']:.2f} ms")

        # the registry proxy: the preheated image through one peer's proxy,
        # then the fresh image through every peer's at once
        image_bytes = layers * (layer_mib << 20)
        n_log = len(log)

        def proxy_step(step: str, repo: str, pullers: list, want: dict) -> dict:
            before, routes0 = sent(), {n: procs.counts(n, _PROXY_TOTAL, "route") for n in pullers}
            t = time.perf_counter()
            with ThreadPoolExecutor(len(pullers)) as pool:
                pulls = dict(zip(pullers, pool.map(lambda n: _proxy_pull(proxies[n], base, repo), pullers)))
            wall = time.perf_counter() - t
            after = sent()
            for n, pull in pulls.items():
                check(pull["layers"] == want, f"download[{device}]: {step}: {n}'s layers are not the origin's")
            routes = {r: sum(procs.counts(n, _PROXY_TOTAL, "route").get(r, 0.0) - routes0[n].get(r, 0.0)
                             for n in pullers) for r in ("p2p", "direct")}
            walls = sorted(p["wall_s"] for p in pulls.values())
            step_out = {
                "peers": len(pullers), "wall_s": wall, "peer_wall_p50_s": float(np.percentile(walls, 50)),
                "peer_wall_max_s": walls[-1], "aggregate_mib_per_s": len(pullers) * image_bytes / (1 << 20) / wall,
                "origin_blob_bytes": sum(after.get(k, 0) - before.get(k, 0) for k in after
                                         if k.startswith(f"{repo}/blobs/")),
                "routes": routes, "via_p2p": sorted({v for p in pulls.values() for v in p["via_p2p"]}),
                "task_ids": sorted({i for p in pulls.values() for i in p["task_ids"]}),
            }
            step_out["origin_egress_x"] = step_out["origin_blob_bytes"] / image_bytes
            print(f"download[{device}]: proxy, {step}: {len(pullers)} peer(s) × {layers} layers of {layer_mib}"
                  f" MiB in {wall:.2f} s ({step_out['aggregate_mib_per_s']:.1f} MiB/s); peer wall p50"
                  f" {step_out['peer_wall_p50_s']:.2f} s, max {step_out['peer_wall_max_s']:.2f} s; origin blob bytes"
                  f" {step_out['origin_blob_bytes']} ({step_out['origin_egress_x']:.3f}× the image); requests by route"
                  f" {routes}")
            check(routes == {"p2p": len(pullers) * layers, "direct": len(pullers) * 2.0}
                  and step_out["via_p2p"] == ["1"],
                  f"download[{device}]: {step}: not every blob request rode P2P, or a manifest did: {step_out}")
            return step_out

        puller = names[-1]  # a peer that holds no layer of the preheated image
        out["proxy_preheated"] = proxy_step("preheated image", IMAGE_PATH, [puller], layer_sha)
        check(out["proxy_preheated"]["origin_blob_bytes"] == 0,
              f"download[{device}]: the preheated image's pull through the proxy reached the origin")
        check(out["proxy_preheated"]["task_ids"] == sorted(result["triggered"]),
              f"download[{device}]: the proxy's tasks are not the preheat's: {out['proxy_preheated']['task_ids']}")
        out["proxy_fresh"] = proxy_step("fresh image, every peer at once", FRESH_IMAGE_PATH, names[1:], fresh_sha)
        check(out["proxy_fresh"]["origin_egress_x"] < peers + 1,
              f"download[{device}]: the fresh image's egress is {out['proxy_fresh']['origin_egress_x']:.3f}×"
              f" the image, not below {peers + 1}×")
        shed = {n: procs.counts(n, "dragonfly_daemon_p2p_inflight_shed_total").get("", 0.0) for n in names}
        fallbacks = {n: len(procs.events(n, "daemon.proxy_fallback")) for n in names}
        proxied = log[n_log:]
        out["proxy_decisions"] = len(proxied)
        print(f"download[{device}]: proxy: {len(proxied)} decisions, rung {evaluator._rung!r},"
              f" {sum(r['served'] is None for r in proxied)} demoted; in-flight sheds {shed};"
              f" proxy_fallback events {fallbacks}")
        check(not any(shed.values()) and not any(fallbacks.values()),
              f"download[{device}]: a proxy pull left the swarm: sheds {shed}, fallbacks {fallbacks}")
        check(proxied and not [r for r in proxied if r["served"] is None] and evaluator._rung == "serving"
              and service.model_kind() == "mlp",
              f"download[{device}]: the proxy pulls' decisions were not all served by the MLP")

        # the object step: a training job writes a model shard through one
        # peer's gateway with seed-on-write; the other peers load it at once,
        # each through its own gateway, and one of them reads a range
        import os

        from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1

        cli_env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                       PYTHONPATH=str(Path(__file__).resolve().parent))

        def dfstore(name: str, *args: str) -> None:
            done = subprocess.run(
                [sys.executable, "-m", "dragonfly2_torch.client.dfstore", "--endpoint", gateways[name], *args],
                capture_output=True, text=True, timeout=600, cwd=str(Path(__file__).resolve().parent), env=cli_env)
            check(done.returncode == 0, f"download[{device}]: dfstore {' '.join(args)} on {name} exited"
                                        f" {done.returncode}: {done.stderr[-2000:]}")

        def object_origin(name: str) -> float:
            return procs.counts(name, _FLOW_BYTES, "provenance", plane="object").get("origin", 0.0)

        object_size = object_mib << 20
        writer, readers = names[1], names[2:]
        n_log = len(log)
        origin0 = {n: object_origin(n) for n in readers}
        # each dfstore is a process of its own: the mb's wall is mostly the
        # interpreter's start, which the cp's wall holds too
        t = time.perf_counter()
        dfstore(writer, "mb", f"df://{OBJECT_BUCKET}")
        mb_s = time.perf_counter() - t
        t = time.perf_counter()
        dfstore(writer, "cp", str(object_src), f"df://{OBJECT_BUCKET}/{OBJECT_KEY}")
        put_s = time.perf_counter() - t
        object_task = task_id_v1(f"file://{objects_dir}/{OBJECT_BUCKET}/{OBJECT_KEY}",
                                 URLMeta(digest=f"sha256:{object_sha}"))
        writer_host = next(h.id for h in srv.resource.host_manager.all() if h.hostname == writer)
        # the writer's import is the shard's first parent: the readers ask
        # once the scheduler holds it
        while not any(p.task.id == object_task and p.host.id == writer_host
                      and p.fsm.is_state(res.PEER_STATE_SUCCEEDED) for p in srv.resource.peer_manager.all()):
            check(time.perf_counter() - t < put_s + 60, f"download[{device}]: the scheduler never held the writer's import")
            time.sleep(0.05)
        t = time.perf_counter()
        with ThreadPoolExecutor(len(readers)) as pool:
            gets = dict(zip(readers, pool.map(
                lambda n: _object_get(gateways[n], OBJECT_BUCKET, OBJECT_KEY), readers)))
        wall = time.perf_counter() - t
        lo, hi = object_size // 3, 2 * object_size // 3 - 1
        ranged_out = DOWNLOAD_WORK / "daemons" / "object-range.out"
        t = time.perf_counter()
        dfstore(readers[0], "cp", f"df://{OBJECT_BUCKET}/{OBJECT_KEY}", str(ranged_out), "--range", f"bytes={lo}-{hi}")
        ranged_s = time.perf_counter() - t
        with open(object_src, "rb") as f:
            f.seek(lo)
            range_want = hashlib.sha256(f.read(hi - lo + 1)).hexdigest()
        range_sha = _sha256_file(ranged_out)
        check(range_sha == range_want, f"download[{device}]: the ranged cp is not the object's bytes {lo}-{hi}")
        for n, got in gets.items():
            check(got["sha256"] == object_sha and got["bytes"] == object_size,
                  f"download[{device}]: {n}'s read of the shard is not the written bytes")
        walls = sorted(g["wall_s"] for g in gets.values())
        step = log[n_log:]
        out["object"] = {
            "object_mib": object_mib, "readers": len(readers), "sha256": object_sha,
            "reader_sha256": sorted({g["sha256"] for g in gets.values()}),
            "range_sha256": range_sha, "range_want_sha256": range_want, "mb_s": mb_s, "put_s": put_s, "wall_s": wall,
            "peer_wall_p50_s": float(np.percentile(walls, 50)), "peer_wall_max_s": walls[-1],
            "aggregate_mib_per_s": len(readers) * object_mib / wall, "ranged_cp_s": ranged_s,
            "reader_origin_bytes": {n: object_origin(n) - origin0[n] for n in readers},
            "via_p2p": sorted({g["via_p2p"] for g in gets.values()}),
            "task_ids": sorted({g["task_id"] for g in gets.values()}),
            "fallbacks": {n: len(procs.events(n, "daemon.object_fallback")) for n in names},
            "decisions": len(step), "object_task_decisions": sum(r["task"] == object_task for r in step),
            "demoted": sum(r["served"] is None for r in step),
        }
        o = out["object"]
        print(f"download[{device}]: object: dfstore mb {mb_s:.2f} s, cp of {object_mib} MiB through {writer}'s"
              f" gateway (seed-on-write) {put_s:.2f} s (walls of the CLI processes);"
              f" {len(readers)} readers at once in {wall:.2f} s"
              f" ({o['aggregate_mib_per_s']:.1f} MiB/s), each p50 {o['peer_wall_p50_s']:.2f} s, max"
              f" {o['peer_wall_max_s']:.2f} s; the ranged cp of {(hi - lo + 1) / (1 << 20):.2f} MiB in"
              f" {ranged_s:.2f} s;"
              f" the readers' object-plane origin bytes {o['reader_origin_bytes']}; object_fallback events"
              f" {o['fallbacks']}; {o['decisions']} decisions ({o['object_task_decisions']} on the shard's task),"
              f" {o['demoted']} demoted")
        check(o["task_ids"] == [object_task] and o["via_p2p"] == ["1"],
              f"download[{device}]: the readers did not ride the writer's task: {o}")
        check(not any(o["reader_origin_bytes"].values()),
              f"download[{device}]: a reader's gateway read reached the backend: {o['reader_origin_bytes']}")
        check(not any(o["fallbacks"].values()), f"download[{device}]: an object GET left the swarm: {o['fallbacks']}")
        check(o["object_task_decisions"] > 0 and not o["demoted"] and evaluator._rung == "serving"
              and service.model_kind() == "mlp",
              f"download[{device}]: the object step's decisions were not all served by the MLP: {o}")

        # the S3 step: every peer dfgets one object of an S3 bucket at once;
        # the daemons sign with the credentials in their environment
        s3_size = s3_mib << 20
        s3_url = f"s3://{S3_BUCKET}/{S3_KEY}"
        listed = source.client_for(s3_url).list(f"s3://{S3_BUCKET}/", headers={
            "X-Dragonfly-S3-Access-Key": S3_ACCESS_KEY, "X-Dragonfly-S3-Secret-Key": S3_SECRET_KEY,
            "X-Dragonfly-S3-Endpoint": s3_endpoint})
        check([(e.name, e.url, e.is_dir) for e in listed] == [(S3_KEY, s3_url, False)],
              f"download[{device}]: the S3 listing gave {listed}")
        with urllib.request.urlopen(f"{s3_endpoint}/_sent", timeout=30) as r:
            s3_before = json.loads(r.read())
        n_log = len(log)
        outputs = {n: DOWNLOAD_WORK / "daemons" / f"{n}.s3.out" for n in names[1:]}
        walls = {}

        def s3_pull(name):
            t = time.perf_counter()
            dfget.download(procs.address(name), s3_url, str(outputs[name]))
            walls[name] = time.perf_counter() - t

        t = time.perf_counter()
        with ThreadPoolExecutor(peers) as pool:
            list(pool.map(s3_pull, names[1:]))
        wall = time.perf_counter() - t
        with ThreadPoolExecutor(peers) as pool:
            shas = dict(zip(names[1:], pool.map(lambda n: _sha256_file(outputs[n]), names[1:])))
        for n, sha in shas.items():
            check(sha == s3_sha, f"download[{device}]: {n}'s {s3_url} is not the bucket's bytes")
        with urllib.request.urlopen(f"{s3_endpoint}/_sent", timeout=30) as r:
            s3_after = json.loads(r.read())
        key_path = f"/{S3_BUCKET}/{S3_KEY}"
        step = log[n_log:]
        wall_list = sorted(walls.values())
        out["s3"] = {
            "object_mib": s3_mib, "peers": peers, "sha256": s3_sha, "peer_sha256": sorted(set(shas.values())),
            "listed": len(listed), "wall_s": wall,
            "peer_wall_p50_s": float(np.percentile(wall_list, 50)), "peer_wall_max_s": wall_list[-1],
            "aggregate_mib_per_s": peers * s3_mib / wall,
            "egress_bytes": s3_after["sent"].get(key_path, 0) - s3_before["sent"].get(key_path, 0),
            "refused": s3_after["refused"], "decisions": len(step),
            "demoted": sum(r["served"] is None for r in step),
        }
        o = out["s3"]
        o["egress_x"] = o["egress_bytes"] / s3_size
        print(f"download[{device}]: s3: {peers} × {s3_mib} MiB from {s3_url} at once in {wall:.2f} s"
              f" ({o['aggregate_mib_per_s']:.1f} MiB/s), each p50 {o['peer_wall_p50_s']:.2f} s, max"
              f" {o['peer_wall_max_s']:.2f} s; the stand-in's egress {o['egress_bytes']} bytes"
              f" ({o['egress_x']:.3f}× the object); {o['refused']} refused with 403; {o['decisions']} decisions,"
              f" {o['demoted']} demoted")
        check(o["egress_x"] < peers + 1, f"download[{device}]: the S3 egress is {o['egress_x']:.3f}× the object")
        check(o["refused"] == 0, f"download[{device}]: the S3 stand-in refused {o['refused']} requests")
        check(o["decisions"] > 0 and not o["demoted"] and evaluator._rung == "serving"
              and service.model_kind() == "mlp",
              f"download[{device}]: the S3 step's decisions were not all served by the MLP: {o}")

        # records and probes
        srv.storage.flush()
        out["records"] = len(srv.storage.list_download())
        check(out["records"] >= peers, f"download[{device}]: {out['records']} download records written")
        ids = {h.id: h.hostname for h in srv.resource.host_manager.all()}
        pairs = [tuple(k.split(":")[1:3]) for k in srv.kvstore.scan_iter("networktopology:*")]
        srv.topology_engine.flush()
        held = [p for p in pairs if srv.topology_engine.est_rtt_detail(*p)[1] == "direct"]
        out["probes"] = {"pairs": len(pairs), "held": len(held), "engine_edges": len(srv.topology_engine.store.edges)}
        print(f"download[{device}]: {out['records']} download records; {len(pairs)} probed pairs among"
              f" {len(ids)} hosts, {len(held)} held by the engine ({out['probes']['engine_edges']} edges)")
        check(pairs and len(held) == len(pairs), f"download[{device}]: the engine lacks probed pairs")

        # the load generator (python -m dragonfly2_torch.tools.stress --url
        # … --daemon | --proxy): requests through one peer's gRPC Download,
        # then through its registry proxy, each a task of its own. Last in
        # the leg: every task's child holds an upload slot of its parent's
        # host until the child leaves, so the seed peer's host has fewer
        # free slots after it (printed)
        def slots():
            return {h.hostname: h.concurrent_upload_count for h in srv.resource.host_manager.all()}

        before = slots()
        out["stress_run"] = stress_run_step(device, files, base, procs.address(peer0), proxies[peer0], seed)
        out["stress_run"]["upload_slots_held"] = {"before": before, "after": slots()}
        print(f"download[{device}]: upload slots held by host before the load generator {before}, after"
              f" {out['stress_run']['upload_slots_held']['after']}")
    finally:
        procs.stop()
        if srv is not None:
            srv.stop()
        if ops_channel is not None:
            ops_channel.close()
        if mgr is not None:
            mgr.stop()
        for proc in (origin, s3):
            if proc is not None:
                proc.kill()
                proc.join()
        shutil.rmtree(DOWNLOAD_WORK, ignore_errors=True)
    return out


FLEET_WORK = Path(__file__).resolve().parent / "build" / "fleet_leg"
# the scheduler fleet: the shard-kill soak's 3 schedulers behind one hash
# ring (the reference's tools/stress.py --chaos --shard-kill), each its own
# process on the card, leased in the manager's embedded KV
FLEET_SCHEDULERS = 3
# every flight event of the leg's processes kept: a 1 GiB pull's pieces
# would push the peers' decisions out of the default 512-event rings
FLEET_FLIGHT_RING = 65536
# the peer states in which a parent is fed, so a scheduler may hand it out
# (a Pending or Received* peer is a bad node to the candidate filter)
FLEET_FED_STATES = ("Running", "BackToSource", "Succeeded")


def _blackouts(events) -> "list[float]":
    """A daemon's announce-plane outages in ms from its
    ``daemon.peer_decision`` events, as its conductor times them: from a
    peer's first ``stream_error`` to its next decision."""
    started, out = {}, []
    for e in sorted(events, key=lambda e: e["ts_ns"]):
        if e["decision"] == "stream_error":
            started.setdefault(e["peer_id"], e["ts_ns"])
        elif e["decision"] != "schedule_timeout" and e["peer_id"] in started:
            out.append((e["ts_ns"] - started.pop(e["peer_id"])) / 1e6)
    return out


def fleet_leg(
    device, peers=DOWNLOAD_PEERS, file_mib=DOWNLOAD_FILE_MIB, piece_length=0, schedulers=FLEET_SCHEDULERS,
    lease_ttl=None, renew=None, poll=None, piece_delay_ms=0, seed=0,
) -> dict:
    """The scheduler fleet failing over a SIGKILLed member. The port's
    ``ManagerServer`` as shipped with its embedded RESP KV server
    (``kv_port=0``); ``schedulers`` schedulers, each ``python -m
    dragonfly2_torch.scheduler`` in its own process (``algorithm="ml"`` on
    ``device``, seed peers enabled, ``fleet_enabled`` over the manager's
    KV, registered with the manager), with ``FleetConfig`` and
    ``ReplicationConfig`` at their defaults (lease 3 s, renew 1 s, poll
    1 s, grace 10 s; a flush every 0.25 s of up to 64 tasks, backlog
    1,024, replicas kept 600 s) unless ``lease_ttl``, ``renew`` or
    ``poll`` is given; each installs the seeded MLP ``[19, 128, 128, 1]``,
    uploaded inactive (which no poll may install) and activated through
    the manager. Then a seed peer and ``peers`` peers of the port's
    daemons (``_DaemonProcs``) with the manager's and the KV's addresses
    and no static scheduler list. An origin in its own process serves a
    ``file_mib`` MiB file made from ``seed``.

    1. The fleet forms: ``read_members`` over RESP gives the schedulers'
       addresses, ``ListSchedulers`` for the daemons' address returns
       exactly those, and every daemon's /metrics reads ``fleet_members``
       equal to their count.
    2. The owner dies mid-burst: the file's task is owned by scheduler V
       on the ring, S is its ring successor and T the third. Every peer
       but the last ``dfget``s the file at once; once the KV holds V's
       replica of the task at the settled epoch with at least 2 peers in
       it, one of them fed (``FLEET_FED_STATES``) with pieces on record,
       V's process gets SIGKILL (a pull of the burst still running). A
       replica caught before any peer was fed would leave S no parent to
       hand out: a peer busy pulling reads no announce error and never
       re-registers, so S knows the burst's peers as the replica left
       them.
       Then the last peer, which had not asked for the file, ``dfget``s
       it: its register lands on S once V's lease is gone.
    3. A member leaves gracefully: T gets SIGTERM; its lease must be gone
       before one ``lease_ttl`` has passed, and ``ListSchedulers`` then
       returns S alone.

    Checks: every output's sha256 is the origin's; origin egress below
    ``peers + 1`` times the file; the adoption receipt
    ``swarm:adopt:<task>`` reads ``adopted`` by S with V as the victim;
    the late peer takes ≥ 90 % of its bytes from peers, its decision at S
    (``scheduler.schedule`` in S's /debug/ring) names a parent of V's
    replica, and every decision it got was served on S's ``serving`` rung
    (``scheduler.evaluate_explain``) by S's MLP (Diagnose:
    ``scheduler.serving`` and ``scheduler.device``), with no wave demoted
    and no rung dropped on S; no daemon counts a
    ``fleet_failover_resume_total{kind="fallback"}``; and every blackout
    (each daemon's ``daemon.peer_decision`` events, as many as its
    ``fleet_blackout_milliseconds`` counted) is below ``lease_ttl +
    poll_interval + 8`` s. ``piece_delay_ms`` slows every piece a daemon
    reads (a fault rule), so that a tiny rehearsal's burst outlives the
    kill."""
    import multiprocessing
    import os
    import signal
    import urllib.request

    from dragonfly2_torch.client import dfget
    from dragonfly2_torch.rpc import glue
    from dragonfly2_torch.scheduler import fleet
    from dragonfly2_torch.scheduler.swarm_replication import ReplicationConfig
    from dragonfly2_torch.tools import dfswarm
    from dragonfly2_torch.tools.stress import diagnose_probes
    from dragonfly2_torch.utils import kvstore
    from dragonfly2_torch.utils.idgen import URLMeta

    device = torch.device(device)
    given = {"lease_ttl": lease_ttl, "renew_interval": renew, "poll_interval": poll}
    cfg = fleet.FleetConfig(**{k: v for k, v in given.items() if v is not None})
    repl = ReplicationConfig()
    bound_ms = (cfg.lease_ttl + cfg.poll_interval + 8.0) * 1e3
    rng = np.random.default_rng(seed)
    names = ["seed"] + [f"peer-{i}" for i in range(peers)]
    burst, late = names[1:-1], names[-1]
    sched_names = [f"sched-{i}" for i in range(schedulers)]
    out = {"schedulers": schedulers, "peers": peers, "file_mib": file_mib, "lease_ttl": cfg.lease_ttl,
           "renew_interval": cfg.renew_interval, "poll_interval": cfg.poll_interval, "grace_s": cfg.grace_s,
           "replication": {k: getattr(repl, k) for k in ReplicationConfig.__slots__}}
    daemons = _DaemonProcs(FLEET_WORK / "daemons")
    scheds = _DaemonProcs(FLEET_WORK / "schedulers", module="dragonfly2_torch.scheduler", card=device.type == "cuda")
    origin = mgr = ops_channel = kv = pool = None
    try:
        t_leg = time.perf_counter()
        shutil.rmtree(FLEET_WORK, ignore_errors=True)
        for d in ("daemons", "schedulers"):
            (FLEET_WORK / d).mkdir(parents=True)
        files = FLEET_WORK / "origin"
        file_sha = _seeded_file(files / "blob.bin", file_mib, rng)
        ctx = multiprocessing.get_context("spawn")
        here, there = ctx.Pipe()
        origin = ctx.Process(target=_origin_process, args=(there, str(files)), daemon=True)
        origin.start()
        there.close()
        base = f"http://127.0.0.1:{here.recv()}"
        here.close()

        mgr, mgr_addr, ops_channel, ops, pb2, _ = manager_server(FLEET_WORK / "manager", kv_port=0)
        check(mgr.kv_addr is not None and mgr.service.fleet_kv is not None, "the manager embeds no KV server")
        kv = kvstore.RemoteKVStore(mgr.kv_addr)
        blob = serialize_params(init_mlp(torch.Generator().manual_seed(seed), MLP_DIMS))
        up = ops.CreateModel(pb2.CreateModelRequest(model_id="mlp-seeded", type="mlp", weights=blob))
        check((up.version, up.state) == (1, "inactive"), f"the seeded MLP landed as {up.version} {up.state}")
        lease = {f"fleet_{k}": v for k, v in given.items() if v is not None}
        t0 = time.perf_counter()
        scheds.start({n: dict(algorithm="ml", device=device.type, manager_address=mgr_addr, kv_address=mgr.kv_addr,
                              fleet_enabled="true", seed_peer_enabled="true", model_refresh_interval=1.0,
                              job_poll_interval=3600.0, **lease) for n in sched_names},
                     timeout=300.0, env={"DF_FLIGHT_RING": str(FLEET_FLIGHT_RING)})
        out["schedulers_up_s"] = time.perf_counter() - t0
        addrs = {n: scheds.address(n) for n in sched_names}
        members = sorted(addrs.values())
        by_addr = {a: n for n, a in addrs.items()}
        # the refresher polled once at serve: nothing active to install
        for n in sched_names:
            kind = diagnose_probes(addrs[n])["scheduler.serving"]["model_kind"]
            check(kind == "", f"fleet[{device}]: {n} installed the inactive seeded MLP ({kind!r})")
        t0 = time.perf_counter()
        activate(ops, pb2, "mlp-seeded", 1)
        installed, probes = {}, {}
        while len(installed) < len(sched_names):
            check(time.perf_counter() - t0 < 120, f"fleet[{device}]: the activated MLP reached only {sorted(installed)}")
            for n in sched_names:
                if n not in installed:
                    probes[n] = diagnose_probes(addrs[n])
                    if probes[n]["scheduler.serving"]["model_kind"] == "mlp":
                        installed[n] = (time.perf_counter() - t0) * 1e3
            time.sleep(0.05)
        out["activation_to_install_ms"] = installed
        for n in sched_names:
            if device.type == "cuda":
                check(probes[n].get("scheduler.device", {}).get("device", "").startswith("cuda"),
                      f"fleet[{device}]: {n} serves off the card: {probes[n].get('scheduler.device')}")
        print(f"fleet[{device}]: {schedulers} schedulers up in {out['schedulers_up_s']:.2f} s; the seeded MLP"
              f" uploaded inactive, not installed by a poll; activated → installed in"
              f" {', '.join(f'{n} {ms:.1f} ms' for n, ms in installed.items())}")

        # 1. the fleet forms
        check(fleet.read_members(kv) == members, f"fleet[{device}]: the leases read {fleet.read_members(kv)}")
        listed = ops.ListSchedulers(pb2.ListSchedulersRequest(ip="127.0.0.1"))
        check(sorted(f"{s.ip}:{s.port}" for s in listed.schedulers) == members,
              f"fleet[{device}]: ListSchedulers gave {listed}")
        common = {"scheduler_address": "''", "manager_address": mgr_addr, "kv_address": mgr.kv_addr}
        if poll is not None:
            common["fleet_poll_interval"] = poll
        if piece_length:
            common["piece_length"] = piece_length
        env = {"DF_FLIGHT_RING": str(FLEET_FLIGHT_RING)}
        if piece_delay_ms:
            env["DF_FAULTS"] = f"daemon.piece_read=delay:{piece_delay_ms}"
        t0 = time.perf_counter()
        daemons.start({n: dict(common, host_type="super" if n == "seed" else "normal") for n in names}, env=env)
        for n in sched_names:
            while diagnose_probes(addrs[n])["scheduler.resource"]["hosts"] < len(names):
                check(time.perf_counter() - t0 < 60, f"fleet[{device}]: {n} was not told of every daemon's host")
                time.sleep(0.05)
        out["daemons_up_s"] = time.perf_counter() - t0
        seen = {n: daemons.counts(n, "dragonfly_fleet_members").get("") for n in names}
        check(all(v == schedulers for v in seen.values()), f"fleet[{device}]: the daemons' fleet_members {seen}")
        print(f"fleet[{device}]: the fleet formed: {len(members)} leases {members}; ListSchedulers gives them;"
              f" {len(names)} daemons up in {out['daemons_up_s']:.2f} s, each reading fleet_members {schedulers}")

        # 2. the owner dies mid-burst
        url = f"{base}/blob.bin"
        task_id = task_id_v1(url, URLMeta())
        order = [by_addr[a] for a in glue.ConsistentHashRing(members).successors(task_id)]
        victim, successor, other = order[0], order[1], order[2]
        out.update(victim=victim, successor=successor, other=other)
        mem = {}
        outputs = {n: FLEET_WORK / "daemons" / f"{n}.out" for n in names[1:]}
        walls = {}

        def pull(name):
            t = time.perf_counter()
            dfget.download(daemons.address(name), url, str(outputs[name]))
            walls[name] = time.perf_counter() - t

        def device_memory(n):
            return diagnose_probes(addrs[n]).get("scheduler.device", {}).get("max_memory_allocated")

        pool = ThreadPoolExecutor(len(burst) + 1)
        t_burst = time.perf_counter()
        pulls = {n: pool.submit(pull, n) for n in burst}
        key = kvstore.make_swarm_replica_key(task_id)
        while True:
            check(time.perf_counter() - t_burst < 300, f"fleet[{device}]: no replica of {victim}'s at the epoch")
            epoch, owner, data = kv.hmget(key, ["epoch", "owner", "data"])
            if data is not None and owner == addrs[victim] and int(epoch) == int(kv.get(fleet.FLEET_EPOCH_KEY) or 0):
                replica = {p: (v["state"], v["pieces"]) for p, v in json.loads(data)["obs"]["peers"].items()}
                fed = [p for p, (state, pieces) in replica.items() if state in FLEET_FED_STATES and pieces > 0]
                if len(replica) >= 2 and fed:
                    break
            time.sleep(0.01)
        mem[victim] = device_memory(victim)
        running = [n for n, f in pulls.items() if not f.done()]
        kill_ns, t_kill = time.time_ns(), time.perf_counter()
        scheds.kill(victim, signal.SIGKILL)
        pulls[late] = pool.submit(pull, late)
        check(running, f"fleet[{device}]: the burst ended before the kill")
        out["kill"] = {"after_s": t_kill - t_burst, "replica_epoch": int(epoch), "replica_peers": len(replica),
                       "replica": replica, "pulls_running": len(running)}
        # read before the process is reaped: a killed process that held
        # the card takes seconds to be torn down
        while addrs[victim] in fleet.read_members(kv):
            check(time.perf_counter() - t_kill < cfg.lease_ttl + 30, f"fleet[{device}]: {victim}'s lease never expired")
            time.sleep(0.01)
        out["kill_to_lease_gone_s"] = time.perf_counter() - t_kill
        adopt_key = kvstore.make_swarm_adopt_key(task_id)
        while kv.get(adopt_key) is None:
            check(time.perf_counter() - t_kill < cfg.lease_ttl + cfg.poll_interval + 60,
                  f"fleet[{device}]: no adoption receipt for the task")
            time.sleep(0.01)
        receipt = json.loads(kv.get(adopt_key))
        # the successor re-journals the adopted swarm under its own
        # ownership; the dead owner's last export, which rides the receipt,
        # must survive into it intact (python -m dragonfly2_torch.tools.dfswarm
        # --diff), read as soon as it is there
        t_diff = time.perf_counter()
        while True:
            owner, data = kv.hmget(key, ["owner", "data"])
            if owner and owner != addrs[victim] and data:
                break
            check(time.perf_counter() - t_diff < 30, f"fleet[{device}]: the successor never re-journaled the swarm")
            time.sleep(0.01)
        rejournal_s = time.perf_counter() - t_diff
        t_diff = time.perf_counter()
        diff = dfswarm.diff_replicas(receipt.get("payload") or {}, json.loads(data))
        out["replica_diff"] = {**diff, "owner": owner, "rejournal_wait_s": rejournal_s,
                               "diff_ms": (time.perf_counter() - t_diff) * 1e3}
        check(scheds.procs[victim][0].wait(30) == -signal.SIGKILL, f"fleet[{device}]: {victim} did not die by SIGKILL")
        out["kill"]["reaped_s"] = time.perf_counter() - t_kill
        for n, f in pulls.items():
            f.result()
        pool.shutdown()
        pool = None
        burst_s = max(walls[n] for n in burst)
        with ThreadPoolExecutor(len(outputs)) as shas_pool:
            shas = dict(zip(outputs, shas_pool.map(lambda n: _sha256_file(outputs[n]), outputs)))
        for n, sha in shas.items():
            check(sha == file_sha, f"fleet[{device}]: {n}'s output is not the origin's bytes")
        size = file_mib << 20
        with urllib.request.urlopen(f"{base}/_sent", timeout=30) as r:
            egress = json.loads(r.read()).get("/blob.bin", 0)
        check(egress < (peers + 1) * size, f"fleet[{device}]: origin egress {egress} ≥ {peers + 1}× the file")
        check(receipt["outcome"] == "adopted" and receipt["victim"] == addrs[victim]
              and receipt["adopted_by"] == addrs[successor],
              f"fleet[{device}]: the adoption receipt reads {({k: v for k, v in receipt.items() if k != 'payload'})}")
        era = set(receipt["payload"]["obs"]["peers"])
        adopted = scheds.events(successor, "scheduler.swarm_adopt_ok")
        check(len(adopted) == 1 and adopted[0]["task_id"] == task_id, f"fleet[{device}]: {successor} adopted {adopted}")
        rd = out["replica_diff"]
        print(f"fleet[{device}]: dfswarm --diff of the adoption: the dead owner's {len(era)} peers against the"
              f" re-journal by {by_addr.get(rd['owner'], rd['owner'])} ({rd['rejournal_wait_s']:.3f} s after the"
              f" receipt was read; the diff {rd['diff_ms']:.3f} ms): missing {rd['missing_peers']}, torn"
              f" {rd['torn_peers']}, orphaned {rd['orphaned']}, moved {rd['moved']}, extra {rd['extra_peers']},"
              f" conserved {rd['conserved']}")
        check(rd["owner"] == addrs[successor] and rd["clean"],
              f"fleet[{device}]: the adopted swarm did not survive intact into {rd['owner']}'s replica: {rd}")
        # when the successor's own view dropped the dead member
        seen_gone = [e for e in scheds.events(successor, "scheduler.fleet_reconcile") if addrs[victim] in e["left"]]
        check(len(seen_gone) == 1, f"fleet[{device}]: {successor} saw {victim} leave {len(seen_gone)} times")
        out["adopt"] = {"adopt_ms": receipt["adopt_ms"], "peers": len(era), "epoch": receipt["epoch"],
                        "seq": receipt["seq"], "kill_to_reconcile_s": (seen_gone[0]["ts_ns"] - kill_ns) / 1e9,
                        "kill_to_adopt_s": (adopted[0]["ts_ns"] - kill_ns) / 1e9}

        # the late peer: its one peer id, its bytes, its decisions at S
        late_events = sorted(daemons.events(late, "daemon.peer_decision"), key=lambda e: e["ts_ns"])
        late_ids = {e["peer_id"] for e in late_events}
        check(len(late_ids) == 1, f"fleet[{device}]: the late peer ran {sorted(late_ids)}")
        late_id = late_ids.pop()
        traffic = daemons.traffic(late)
        late_share = traffic.get("remote_peer", 0.0) / max(sum(traffic.values()), 1.0)
        decisions = [e for e in scheds.events(successor, "scheduler.schedule") if e["peer_id"] == late_id]
        explained = [e for e in scheds.events(successor, "scheduler.evaluate_explain") if e["peer_id"] == late_id]
        waves = scheds.events(successor, "scheduler.wave_evaluated")
        falls = scheds.counts(successor, "dragonfly_scheduler_serving_fallback_total", "to")
        s_probes = diagnose_probes(addrs[successor])
        to_source = scheds.events(successor, "scheduler.schedule_back_to_source")
        out["late"] = {"peer_id": late_id, "wall_s": walls[late], "from_peers_share": late_share,
                       "origin_bytes": traffic.get("back_to_source", 0.0), "decisions": len(decisions),
                       "daemon_decisions": [e["decision"] for e in late_events], "traffic": traffic,
                       "back_to_source": [e["reason"] for e in to_source if e["peer_id"] == late_id],
                       "parents": decisions[0]["parent_ids"] if decisions else [],
                       "rungs": sorted({e["rung"] for e in explained}),
                       "successor_kind": s_probes["scheduler.serving"]["model_kind"],
                       "successor_device": s_probes.get("scheduler.device", {}).get("device", "cpu")}
        lt = out["late"]
        check(late_share >= 0.9, f"fleet[{device}]: the late peer took {late_share:.4f} of its bytes from peers:"
                                 f" {lt}; the replica at the kill {replica}")
        check(decisions and set(decisions[0]["parent_ids"]) & era,
              f"fleet[{device}]: the late peer's decision at {successor} names no parent of {victim}'s era: {lt}")
        check(explained and lt["rungs"] == ["serving"] and lt["successor_kind"] == "mlp"
              and lt["successor_device"].startswith(device.type),
              f"fleet[{device}]: the late peer's decisions were not served by {successor}'s MLP on {device}: {lt}")
        check(not any(w["demoted"] for w in waves) and not any(falls.values()),
              f"fleet[{device}]: {successor} demoted a decision: waves {[w['demoted'] for w in waves]}, {falls}")

        # every daemon's failovers: no fallback, every blackout bounded
        resumes, blackouts = {}, {}
        for n in names:
            for kind, v in daemons.counts(n, "dragonfly_fleet_failover_resume_total", "kind").items():
                resumes[kind] = resumes.get(kind, 0) + v
            mine = _blackouts(daemons.events(n, "daemon.peer_decision"))
            counted = daemons.counts(n, "dragonfly_fleet_blackout_milliseconds_count").get("", 0.0)
            check(len(mine) == counted, f"fleet[{device}]: {n} counted {counted} blackouts, its ring holds {len(mine)}")
            blackouts[n] = mine
        every = sorted(b for v in blackouts.values() for b in v)
        out["failover"] = {"resumes": resumes, "blackouts": len(every),
                           "blackout_ms_p50": float(np.percentile(every, 50)) if every else 0.0,
                           "blackout_ms_max": every[-1] if every else 0.0, "bound_ms": bound_ms}
        fo = out["failover"]
        check(not resumes.get("fallback"), f"fleet[{device}]: failovers fell back to the origin: {resumes}")
        check(every and every[-1] < bound_ms, f"fleet[{device}]: blackouts {every} ms against {bound_ms:.0f} ms")
        out["burst"] = {"wall_s": burst_s, "peer_wall_s": {n: walls[n] for n in burst},
                        "aggregate_mib_per_s": len(burst) * file_mib / burst_s, "origin_egress_x": egress / size}
        print(f"fleet[{device}]: burst of {len(burst)} × {file_mib} MiB in {burst_s:.2f} s"
              f" ({out['burst']['aggregate_mib_per_s']:.1f} MiB/s), origin egress {egress / size:.3f}× the file;"
              f" {victim} (the task's owner) SIGKILLed {out['kill']['after_s']:.2f} s in with {len(running)} pulls"
              f" running and a replica of {len(replica)} peers at epoch {int(epoch)} ({len(fed)} fed); its lease gone"
              f" {out['kill_to_lease_gone_s']:.2f} s after the kill (the process reaped after"
              f" {out['kill']['reaped_s']:.2f} s); {successor} saw it leave {out['adopt']['kill_to_reconcile_s']:.2f} s"
              f" and adopted {len(era)} peers {out['adopt']['kill_to_adopt_s']:.2f} s after it (adopt_ms"
              f" {receipt['adopt_ms']})")
        print(f"fleet[{device}]: the late peer pulled in {walls[late]:.2f} s, {late_share:.4f} of its bytes from"
              f" peers, {lt['origin_bytes']:.0f} origin bytes; {len(decisions)} decisions at {successor}, parents"
              f" {lt['parents']} of {victim}'s era, rung {lt['rungs']} on {lt['successor_kind']} ({lt['successor_device']});"
              f" failovers {resumes}; {fo['blackouts']} blackouts p50 {fo['blackout_ms_p50']:.1f} ms, max"
              f" {fo['blackout_ms_max']:.1f} ms (bound {bound_ms:.0f} ms)")

        # 3. a member leaves gracefully
        for n in (successor, other):
            mem[n] = device_memory(n)
        t_term = time.perf_counter()
        scheds.kill(other, signal.SIGTERM)
        while addrs[other] in fleet.read_members(kv):
            check(time.perf_counter() - t_term < cfg.lease_ttl,
                  f"fleet[{device}]: {other}'s lease outlived one lease_ttl after SIGTERM")
            time.sleep(0.002)
        out["sigterm_to_lease_gone_s"] = time.perf_counter() - t_term
        check(scheds.procs[other][0].wait(60) == 0, f"fleet[{device}]: {other} did not stop cleanly on SIGTERM")
        listed = ops.ListSchedulers(pb2.ListSchedulersRequest(ip="127.0.0.1"))
        check([f"{s.ip}:{s.port}" for s in listed.schedulers] == [addrs[successor]],
              f"fleet[{device}]: after {other} left, ListSchedulers gave {listed}")
        out["max_memory_allocated"] = mem
        out["wall_s"] = time.perf_counter() - t_leg
        print(f"fleet[{device}]: {other} SIGTERMed: its lease gone in {out['sigterm_to_lease_gone_s']:.3f} s"
              f" (ttl {cfg.lease_ttl} s), ListSchedulers gives {successor} alone; max_memory_allocated by"
              f" scheduler {mem}; the leg {out['wall_s']:.1f} s")
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        daemons.stop()
        scheds.stop()
        if kv is not None:
            kv.close()
        if ops_channel is not None:
            ops_channel.close()
        if mgr is not None:
            mgr.stop()
        if origin is not None:
            origin.kill()
            origin.join()
        shutil.rmtree(FLEET_WORK, ignore_errors=True)
    return out


AB_WORK = Path(__file__).resolve().parent / "build" / "ab_leg"


def held_on(scorer) -> "set[str]":
    """The device types of every parameter and buffer a scorer's modules hold."""
    mods = [v for v in vars(scorer).values() if isinstance(v, torch.nn.Module)]
    return {t.device.type for m in mods for t in (*m.parameters(), *m.buffers())}


def serving_ledger(profiling) -> dict:
    """The scoring service's two phases as the port's phase ledger holds them
    now: ``scheduler.serving_wait`` (a request's submission to its answer)
    and ``scheduler.serving_batch`` (one batch on the serving thread)."""
    return {name: profiling.phase(f"scheduler.{name}").snapshot() for name in ("serving_wait", "serving_batch")}


def serving_split(serving: dict, before: dict, after: dict) -> dict:
    """The serving soak's batched arms between the ledger's readings
    ``before`` and ``after`` (every round the soak ran): the decisions
    answered by the service and their mean time in it (queue, window and
    batch), the batches and their mean time on the serving thread; beside
    them the reported round's mean decision by Little's law (the soak
    keeps ``serving_peers`` decisions in flight)."""
    def delta(name):
        count = after[name]["count"] - before[name]["count"]
        return count, round((after[name]["total_s"] - before[name]["total_s"]) * 1e3 / max(count, 1), 3)

    decisions, in_service_ms = delta("serving_wait")
    batches, batch_ms = delta("serving_batch")
    return {
        "decisions": decisions,
        "in_service_ms": in_service_ms,
        "batches": batches,
        "batch_ms": batch_ms,
        "decision_ms": round(serving["serving_peers"] / serving["schedule_ops_per_s"] * 1e3, 3),
    }


def ab_leg(device) -> dict:
    """The ``ml`` evaluator's yardsticks on ``device``, as a user runs them
    (``python -m dragonfly2_torch.tools.stress --serving [--wave]`` and
    ``python -m dragonfly2_torch.tools.ab_harness``), each at its defaults:

    1. ``stress.serving_soak``: 32 threads × 20 decisions over 12 candidate
       parents, per call against the batched scoring service (2 ms window);
    2. ``stress.wave_soak``: the same load, waves of 8 decisions against
       one decision a call, both through the service;
    3. ``ab_harness.run_ab``: 10 in-process daemons (5 slow, announcing
       cpu/memory pressure) pull 6 tasks × 4 pieces of 16 KiB under the
       default evaluator; the announcer uploads their records, the trainer
       fits the MLP on ``device`` and uploads it to the port's manager,
       which activates it; the refresher installs it on ``device`` into
       the evaluator and the scoring service, and the same pulls run again;
    4. ``ab_harness.run_gru_ab``: 6 daemons train on 8 tasks × 6 pieces,
       then 5 tasks run with a degrading parent under the installed MLP,
       without and with the GRU.

    Hard checks (a failure raises): no lost submission in either soak,
    wave rankings equal to per-peer ones, every scorer the soaks built and
    every model the A/B installed held on ``device``, phase 2 scored
    through the service, equal piece counts in each A/B's arms, and the
    ``ml`` evaluator's share of pieces from slow parents below the default
    evaluator's (one re-measurement allowed, as the reference's test
    allows). The soaks' throughput and p99 gates, the A/Bs' p50s and the
    GRU's verdict depend on the host's clock: they are printed with their
    verdict, not held."""
    from dragonfly2_torch.tools import ab_harness, stress
    from dragonfly2_torch.utils import profiling

    dev = torch.device(device)
    out: dict = {"walls_s": {}}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        got = fn(*args, **kw)
        out["walls_s"][name] = time.perf_counter() - t0
        return got

    def on_device(what, scorer):
        held = held_on(scorer)
        check(held == {dev.type}, f"ab[{device}]: {what} holds its parameters on {sorted(held)}, not {dev.type}")

    shutil.rmtree(AB_WORK, ignore_errors=True)
    try:
        scorers: list = []
        ledger0 = serving_ledger(profiling)
        serving = out["serving"] = timed("serving_soak", stress.serving_soak, device=device, scorers=scorers)
        print(f"ab[{device}]: serving soak {json.dumps(serving)}")
        print(f"ab[{device}]: serving soak gates (measured, not held): batched"
              f" {serving['schedule_ops_per_s']} against per call {serving['schedule_ops_per_s_per_call']} ops/s"
              f" ({'batched' if serving['schedule_ops_per_s'] > serving['schedule_ops_per_s_per_call'] else 'per call'}"
              f" faster); p99 {serving['schedule_decision_p99_us']} us against its bound"
              f" {serving['serving_p99_bound_us']} us"
              f" ({'within' if serving['schedule_decision_p99_us'] <= serving['serving_p99_bound_us'] else 'past'});"
              f" the CLI's exit {0 if stress.serving_gates(serving) else 1}")
        check(serving["serving_lost"] == 0, f"ab[{device}]: the serving soak lost {serving['serving_lost']}")
        split = out["serving_split"] = serving_split(serving, ledger0, serving_ledger(profiling))
        print(f"ab[{device}]: serving soak's batched arms, every round: {split['decisions']} decisions"
              f" {split['in_service_ms']} ms each in the service (queue, window and batch), {split['batches']}"
              f" batches {split['batch_ms']} ms each on the serving thread; the reported round's decision"
              f" {split['decision_ms']} ms (peers / its rate)")
        wave = out["wave"] = timed("wave_soak", stress.wave_soak, device=device, scorers=scorers)
        print(f"ab[{device}]: wave soak {json.dumps(wave)}")
        print(f"ab[{device}]: wave soak gate (measured, not held): waves {wave['wave_decisions_per_s']} against"
              f" one a call {wave['wave_decisions_per_s_per_op']} decisions/s; the CLI's exit"
              f" {0 if stress.wave_gates(wave) else 1}")
        check(wave["wave_lost"] == 0, f"ab[{device}]: the wave soak lost {wave['wave_lost']}")
        check(wave["wave_rankings_match"] == 1, f"ab[{device}]: wave rankings differ from per-peer ones")
        check(len(scorers) == 2, f"ab[{device}]: the soaks built {len(scorers)} scorers")
        for scorer in scorers:
            on_device("a soak's scorer", scorer)

        # the MLP A/B; one re-measurement, as tests/test_ab_harness.py allows
        out["ab_attempts"] = []
        for attempt in range(2):
            installed: list = []
            got = timed(f"run_ab_{attempt}", ab_harness.run_ab, ab_harness.ABConfig(device=device),
                        workdir=str(AB_WORK / f"ab-{attempt}"), installed=installed)
            out["ab_attempts"].append(got)
            print(f"ab[{device}]: run_ab attempt {attempt}: {json.dumps(got)}")
            # the GRU too, when phase 1 left it enough piece sequences
            kinds = [(arm, kind) for arm, kind, _ in installed]
            check(kinds in ([("ml", "mlp")], [("ml", "mlp"), ("ml", "gru")]), f"ab[{device}]: run_ab installed {kinds}")
            for arm, kind, scorer in installed:
                on_device(f"run_ab's {arm} {kind}", scorer)
            check(got["serving_batches"] > 0, f"ab[{device}]: phase 2 took no batch of the scoring service")
            check(got["pieces_default"] == got["pieces_ml"] > 0,
                  f"ab[{device}]: pieces {got['pieces_default']} (default) against {got['pieces_ml']} (ml)")
            if got["slow_parent_fraction_ml"] < got["slow_parent_fraction_default"]:
                break
        out["ab"] = got
        check(got["slow_parent_fraction_ml"] < got["slow_parent_fraction_default"],
              f"ab[{device}]: the MLP took {got['slow_parent_fraction_ml']} of its pieces from slow parents,"
              f" the default evaluator {got['slow_parent_fraction_default']}")
        print(f"ab[{device}]: slow-parent share {got['slow_parent_fraction_default']} (default) →"
              f" {got['slow_parent_fraction_ml']} (the MLP on {device}); p50 (measured, not held)"
              f" {got['p50_default_ms']} → {got['p50_ml_ms']} ms, ml_wins {got['ml_wins']}")

        installed = []
        g = out["gru"] = timed("run_gru_ab", ab_harness.run_gru_ab,
                               ab_harness.GruABConfig(device=device),
                               workdir=str(AB_WORK / "gru"), installed=installed)
        print(f"ab[{device}]: run_gru_ab {json.dumps(g)}")
        check([(arm, kind) for arm, kind, _ in installed] == [("ml", "mlp"), ("ml_gru", "mlp"), ("ml_gru", "gru")],
              f"ab[{device}]: run_gru_ab installed {[(a, k) for a, k, _ in installed]}")
        for arm, kind, scorer in installed:
            on_device(f"run_gru_ab's {arm} {kind}", scorer)
        check(g["pieces_ml"] == g["pieces_ml_gru"] > 0,
              f"ab[{device}]: pieces {g['pieces_ml']} (ml) against {g['pieces_ml_gru']} (ml_gru)")
        print(f"ab[{device}]: GRU verdict (measured, not held): gru_wins {g['gru_wins']}; degraded-parent share"
              f" {g['degraded_parent_fraction_ml']} → {g['degraded_parent_fraction_ml_gru']}, p50"
              f" {g['p50_ml_ms']} → {g['p50_ml_gru_ms']} ms")
        print(f"ab[{device}]: walls {json.dumps({k: round(v, 2) for k, v in out['walls_s'].items()})}")
    finally:
        # the A/Bs' in-process daemons started the port's stack sampler
        profiling.stop()
        shutil.rmtree(AB_WORK, ignore_errors=True)
    return out


# the soak leg's data-plane race: seconds of load an arm and draws of
# each arm (the CLI's 10 and 2, cut for the script's time limit: the race's
# verdict is printed, not held; the 2,000 children stay)
SOAK_DATA_PLANE_S = 5.0
SOAK_DATA_PLANE_REPEATS = 1


def soak_leg(device) -> dict:
    """The acceptance soaks of ``python -m dragonfly2_torch.tools.stress``, as
    a user runs them, each at the CLI's defaults but the data-plane race
    (``SOAK_DATA_PLANE_S`` an arm, ``SOAK_DATA_PLANE_REPEATS`` draw):

    1. ``--chaos``: a scheduler and two daemons in this process under 5%
       seeded RPC errors (seed 7), the parent's upload server killed and the
       scheduler restarted mid-swarm, 6 downloads and two image tags
       through the daemons' registry proxies;
    2. ``--chaos --shard-kill``: 3 scheduler processes on ``device`` under
       KV leases with the manager's telemetry plane, 240 announce ops, the
       owner of a victim cohort SIGKILLed; then the rebuild arm without
       replication;
    3. ``--registry``: two tags sharing 2 layers (and 1 each) through two
       daemons' proxies, and a dfstore round;
    4. ``--preheat``: 18 tasks, 8 ramping; the planner's GRU forecaster
       fits and forecasts on ``device``;
    5. ``--data-plane``: 2,000 child connections on one upload loop,
       sendfile against buffered.

    Hard checks (a failure raises): each mode's CLI gates but the data
    plane's sendfile-above-buffered race (one draw on the host's clock,
    printed with its verdict); every shard process of both arms reports a
    ``scheduler.device`` probe on ``device`` over ``Diagnose`` (none on
    the CPU); the forecaster's GRU holds its parameters on ``device``."""
    from dragonfly2_torch.tools import stress
    from dragonfly2_torch.utils import profiling

    dev = torch.device(device)
    out: dict = {"walls_s": {}}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        got = out[name] = fn(*args, **kw)
        out["walls_s"][name] = time.perf_counter() - t0
        print(f"soak[{device}]: {name} {json.dumps(got)}")
        return got

    try:
        chaos = timed("chaos", stress.chaos_soak)
        print(f"soak[{device}]: chaos: {chaos['chaos_faults_injected']} faults injected, success"
              f" {chaos['chaos_success_rate']}, {chaos['chaos_hangs']} hangs, swarm consistent"
              f" {chaos['chaos_swarm_consistent']} over {chaos['chaos_swarm_samples']} samples, dedup"
              f" {chaos['chaos_layer_dedup_ratio']}, in {chaos['chaos_wall_s']} s")
        check(stress.chaos_gates(chaos), f"soak[{device}]: the chaos soak failed its gates: {chaos}")

        probes: list = []
        sk = timed("shard_kill", stress.shard_kill_soak, device=device, probes=probes)
        print(f"soak[{device}]: shard-kill: success {sk['fleet_success_rate']}, {sk['fleet_hangs']} hangs,"
              f" fleet_blackout_ms {sk['fleet_blackout_ms']}, fleet_manager_blackout_ms"
              f" {sk.get('fleet_manager_blackout_ms')}, replicated {sk['fleet_blackout_ms_replicated']} against"
              f" rebuild {sk['fleet_blackout_ms_rebuild']} ms, swarm_adopt_ms {sk['swarm_adopt_ms']}"
              f" ({sk['swarm_adopt_outcome']}), replica diff clean {sk['swarm_replica_diff_clean']}; the arms"
              f" {sk['fleet_wall_s']} and {sk['fleet_rebuild_wall_s']} s")
        check(stress.shard_kill_gates(sk), f"soak[{device}]: the shard-kill soak failed its gates: {sk}")
        held = [p.get("scheduler.device", {}).get("device", "") for p in probes]
        check(len(probes) == 2 * sk["fleet_shards"] and all(
            d.startswith("cuda") if dev.type == "cuda" else d == "" for d in held),
            f"soak[{device}]: the shard processes' device probes read {held}")

        reg = timed("registry", stress.registry_soak)
        check(stress.registry_gates(reg), f"soak[{device}]: the registry soak failed its gates: {reg}")

        forecasters: list = []
        heat = timed("preheat", stress.preheat_soak, device=device, forecasters=forecasters)
        print(f"soak[{device}]: preheat: cold-start p50 {heat['preheat_cold_p50_ms']} ms armed against"
              f" {heat['preheat_cold_p50_ms_nopreheat']} ms off, hit ratio {heat['preheat_hit_ratio']},"
              f" {heat['forecast_rate']} forecasts/s, installs in the steady sweeps {heat['preheat_retraces']},"
              f" forecast calls a sweep {heat['preheat_h2d_per_sweep']}, on {heat['preheat_backend']}")
        check(stress.preheat_gates(heat), f"soak[{device}]: the preheat soak failed its gates: {heat}")
        check(len(forecasters) == 1 and held_on(forecasters[0]) == {dev.type},
              f"soak[{device}]: the forecaster's GRU holds its parameters on"
              f" {[sorted(held_on(f)) for f in forecasters]}, not {dev.type}")

        dp = timed("data_plane", stress.data_plane_race, duration_s=SOAK_DATA_PLANE_S,
                   repeats=SOAK_DATA_PLANE_REPEATS)
        faster = dp["data_plane_bytes_per_s"] > dp["data_plane_bytes_per_s_buffered"]
        print(f"soak[{device}]: data plane: {dp['data_plane_connections']} children, sendfile"
              f" {dp['data_plane_bytes_per_s']} B/s (p99 {dp['piece_serve_p99_us']} us) against buffered"
              f" {dp['data_plane_bytes_per_s_buffered']} B/s (p99 {dp['piece_serve_p99_us_buffered']} us):"
              f" {'sendfile' if faster else 'buffered'} faster (measured, not held); RSS {dp['daemon_rss_mb']} MB;"
              f" the CLI's exit {0 if stress.data_plane_gates(dp, dp['data_plane_children']) else 1}")
        check(dp["data_plane_hangs"] == 0 and dp["data_plane_errors"] == 0 and dp["data_plane_requests"] > 0
              and dp["data_plane_connections"] >= dp["data_plane_children"],
              f"soak[{device}]: the data-plane race failed its gates: {dp}")
        print(f"soak[{device}]: walls {json.dumps({k: round(v, 2) for k, v in out['walls_s'].items()})}")
    finally:
        # the soaks' in-process daemons started the port's stack sampler
        profiling.stop()
    return out


def encoder_inputs(batch: int, seq: int, in_dim: int, seed: int) -> torch.Tensor:
    """Seeded piece histories [B, T, F]: a piece's log cost and its position."""
    rng = np.random.default_rng(seed)
    x = np.zeros((batch, seq, in_dim), np.float32)
    x[..., 0] = np.log1p(rng.lognormal(np.log(40.0), 0.8, (batch, seq)))  # piece cost
    x[..., 1] = (np.arange(seq) + 1) / seq  # piece position
    return torch.from_numpy(x)


def encoder_leg(
    device, batch=ENCODER_BT[0], seq=ENCODER_BT[1], cfg=ENCODER, seed=0, dtype=torch.bfloat16
) -> dict:
    """The encoder forward with flash attention in ``dtype``, against
    ``local_attention`` on the same weights; on the card every layer must
    launch the kernel ``flash.kernel_for`` names, and no other."""
    device = torch.device(device)
    enc = init_transformer(torch.Generator().manual_seed(seed), **cfg)
    enc = enc.to(device).requires_grad_(False)
    x = encoder_inputs(batch, seq, cfg["in_dim"], seed).to(device)

    def flash_causal(q, k, v):
        return flash.flash_attention(q, k, v, causal=True)

    def forward():
        with torch.no_grad():
            return apply_transformer(enc, x, attention_fn=flash_causal, compute_dtype=dtype)

    flash.reset_launches()
    out = forward()
    sync(device)
    launches = dict(flash.LAUNCHES_BY)
    taken = flash.kernel_for(dtype, cfg["model_dim"] // cfg["num_heads"])
    expected = {kern: 0 for kern in launches}
    if device.type == "cuda":
        expected[taken] = cfg["num_layers"]
    check(launches == expected, f"flash launches {launches}, expected {expected}")
    with torch.no_grad():
        ref = apply_transformer(enc, x, causal=True, compute_dtype=dtype)
    err = (out - ref).abs().max().item()
    tol = ENCODER_TOL[dtype]
    name = f"encoder[{device}, {str(dtype)[6:]}]"
    print(f"{name}: B={batch} T={seq} out={tuple(out.shape)} launches={launches}"
          f" max|flash - local|={err:.3g} (tol {tol:g})")
    check(out.shape == (batch, seq, cfg["model_dim"]), "encoder output shape")
    check(torch.isfinite(out).all().item(), "encoder output not finite")
    check(err <= tol, "encoder with flash differs from local_attention")
    fwd_ms = wall_ms(forward, 3, device)
    local_ms = wall_ms(
        lambda: apply_transformer(enc, x, causal=True, compute_dtype=dtype), 3, device
    )
    print(f"{name}: forward_ms={fwd_ms:.2f} (with local_attention {local_ms:.2f})")
    return {
        "kernel": taken,
        "launches": launches[taken],
        "launches_by": launches,
        "err": err,
        "forward_ms": fwd_ms,
        "local_forward_ms": local_ms,
    }


def encoder_grad_leg(
    device, batch=ENCODER_BT[0], seq=ENCODER_BT[1], cfg=ENCODER, seed=0, dtype=torch.bfloat16
) -> dict:
    """The encoder trained through the flash kernels: ``apply_transformer``
    with Ulysses attention (``use_kernel``) over an sp = 1 process group
    (NCCL on the card, gloo on the CPU), a seeded loss, ``backward()``. On
    the card every layer must launch its forward kernel and the backward
    kernel once, and nothing else; every parameter's gradient is held
    against the same step with ``local_attention`` under autograd."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1
    )
    try:
        mesh = make_mesh(sp=1)
        ulysses = make_ulysses_attention(mesh, "sp", causal=True, use_kernel=True)
        enc = init_transformer(torch.Generator().manual_seed(seed), **cfg).to(device)
        x = encoder_inputs(batch, seq, cfg["in_dim"], seed).to(device)
        w = torch.randn(
            (batch, seq, cfg["model_dim"]), generator=torch.Generator().manual_seed(seed + 1)
        ).to(device)

        def step(attention_fn):
            enc.zero_grad(set_to_none=True)
            out = apply_transformer(enc, x, attention_fn=attention_fn, causal=True, compute_dtype=dtype)
            ((out * w).sum() / out.numel()).backward()
            return out

        flash.reset_launches()
        out = step(ulysses)
        sync(device)
        launches = dict(flash.LAUNCHES_BY)
        grads = {n: p.grad.clone() for n, p in enc.named_parameters() if p.grad is not None}
        expected = {kern: 0 for kern in launches}
        if device.type == "cuda":
            head_dim = cfg["model_dim"] // cfg["num_heads"]
            expected[flash.kernel_for(dtype, head_dim)] = cfg["num_layers"]
            expected[flash.bwd_kernel_for(dtype, head_dim)] = cfg["num_layers"]
        check(launches == expected, f"flash launches {launches}, expected {expected}")
        check(out.shape == (batch, seq, cfg["model_dim"]) and torch.isfinite(out).all().item(),
              "encoder output shape or finiteness")
        check(all(torch.isfinite(g).all().item() for g in grads.values()), "a gradient is not finite")
        step(None)
        ref = {n: p.grad for n, p in enc.named_parameters() if p.grad is not None}
        check(grads.keys() == ref.keys(), "flash and local_attention train different parameters")
        errs = {n: ((grads[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item() for n in ref}
        qk = [n for n in errs if n.endswith((".wq", ".wk"))]
        worst = max(errs[n] for n in errs if n not in qk)
        worst_qk = max(errs[n] for n in qk)
        tol, tol_qk = ENCODER_GRAD_TOL[dtype], ENCODER_GRAD_QK_TOL[dtype]
        name = f"encoder_grad[{device}, {str(dtype)[6:]}]"
        print(
            f"{name}: B={batch} T={seq} launches={launches}; ||g_flash - g_local||/||g_local||:"
            f" worst {worst:.3g} (tol {tol:g}), wq/wk worst {worst_qk:.3g} (tol {tol_qk:g}); "
            + " ".join(f"{n}={e:.3g}" for n, e in errs.items() if n.startswith("layers.0.") or n == "embed")
        )
        check(worst <= tol and worst_qk <= tol_qk, f"{name}: gradients differ from local_attention's")

        result = {
            "kernel": flash.kernel_for(dtype, cfg["model_dim"] // cfg["num_heads"]),
            "launches_by": launches,
            "grad_rel_err": worst,
            "grad_rel_err_qk": worst_qk,
            "fwd_bwd_ms": wall_ms(lambda: step(ulysses), 3, device),
            "local_fwd_bwd_ms": wall_ms(lambda: step(None), 3, device),
        }
        if device.type == "cuda":
            for key, fn in (("peak_gib", ulysses), ("local_peak_gib", None)):
                enc.zero_grad(set_to_none=True)
                torch.cuda.reset_peak_memory_stats(device)
                step(fn)
                sync(device)
                result[key] = torch.cuda.max_memory_allocated(device) / 2**30
        print(
            f"{name}: fwd_bwd_ms={result['fwd_bwd_ms']:.2f} (with local_attention"
            f" {result['local_fwd_bwd_ms']:.2f}); peak memory"
            f" {result.get('peak_gib', float('nan')):.3f} GiB (with local_attention"
            f" {result.get('local_peak_gib', float('nan')):.3f} GiB)"
        )
        return result
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    walls = {}  # phase → its host wall in s

    def leg(name, fn, *args, attention=False, **kw):
        """One phase, timed; a leg with no attention launches no flash kernel."""
        flash.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = time.perf_counter() - t0
        print(f"chip_smoke: {name} took {walls[name]:.1f} s")
        check(attention or flash.LAUNCHES == 0, f"the {name} leg runs no attention")
        return out

    leg("build", build_kernels, attention=True)
    prepass = leg("prepass", prepass_phase, attention=True)
    rows = leg("flash", flash_phase, attention=True)
    bwd_rows = leg("bwd", bwd_phase, attention=True)

    serve = leg("serve", serve_leg, "cuda")
    scheduler = leg("scheduler", scheduler_leg, "cuda")
    manager = _Manager()
    # cut to the time limit on a slow host (the legs move 1.3-2x with it),
    # depth only: the trainer leg's upload at 1 file of 100 MiB (11 before
    # the server leg), its GRU at the newest 10,000 sequences (40,000), its
    # waves on the trained models at 1 (3) and, since the fleet leg (42.6 s
    # alone in its first call on one H100 machine), its GNN at 40 epochs
    # (60; at 30 the fit ended at 0.89 of its mean predictor's mse); the
    # crash drill at 3 epochs (4) and the preheat sweep's first
    # fit at 4 epochs (the forecaster's 8), since the fleet leg too; the
    # server leg keeps its cluster (10,000 hosts x 16 probes) and cuts its
    # traffic to 8 tasks x 256 peers in phase 1 (40, then 16, then 12
    # tasks) and 32 children in phase 2 (256, then 128, then 64)
    trainer = leg("trainer", trainer_leg, "cuda", manager=manager, files=1, gru_max_sequences=10_000,
                  gnn_epochs=40, serve=dict(tasks=40, peers=256, wave_size=256, waves=1, warmup=1))
    # the crash drill cuts the GNN fit to 3 epochs (40 in the round)
    resume = leg("resume", resume_phase, "cuda", epochs=3)
    federation = leg("federation", federation_phase, "cuda")
    preheat = leg("preheat", preheat_leg, "cuda", manager, forecast_epochs=4)
    server = leg("server", server_leg, "cuda", tasks=8, phase2=32)
    native_csv = leg("native", native_phase, "cuda")
    mesh = leg("mesh", mesh_phase, "cuda")
    check(mesh["backend"] == "nccl", f"the mesh phase ran over {mesh['backend']}, not NCCL")
    download = leg("download", download_leg, "cuda")
    # the scheduler fleet: 3 scheduler processes on the card, the owner
    # of the burst's task SIGKILLed mid-burst, a second member SIGTERMed
    fleet_run = leg("fleet", fleet_leg, "cuda")
    # the ml evaluator's yardsticks: the scoring soaks and the A/Bs, with
    # the MLP and the GRU trained and served on the card
    ab = leg("ab", ab_leg, "cuda")
    # the acceptance soaks of tools/stress.py: chaos, shard-kill (its
    # schedulers on the card), registry, preheat (its forecaster on the
    # card) and the data-plane race
    soak = leg("soak", soak_leg, "cuda")
    encoders = {
        kern: leg(f"encoder_{kern}", encoder_leg, "cuda", dtype=dtype, attention=True)
        for kern, dtype in (("sm90", torch.bfloat16), ("tf32x3", torch.float32))
    }
    for kern, out in encoders.items():
        check(out["kernel"] == kern, f"the {out['kernel']} kernel took the {kern} leg")
    grad_legs = {
        name: leg(f"encoder_grad_{name}", encoder_grad_leg, "cuda", dtype=dtype, attention=True)
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32))
    }

    print(json.dumps({
        "serve": serve,
        "scheduler": scheduler,
        "trainer": trainer,
        "resume": resume,
        "federation": federation,
        "native": native_csv,
        "mesh": mesh,
        "preheat": preheat,
        "server": server,
        "download": download,
        "fleet": fleet_run,
        "ab": ab,
        "soak": soak,
        "encoder": encoders,
        "encoder_grad": grad_legs,
        "tf32x3_d8_bf16": rows["tf32x3_d8_bf16"],
        "tf32x3_prepass_ms": prepass["tf32x3"],
        "tf32x3_bwd_prepass_ms": prepass["bwd_tf32x3"],
        "walls_s": walls,
    }))
    kernels = [
        {
            "name": KERNEL_NAMES[kern],
            "route": "cuda",
            "source": f"dragonfly2_torch/csrc/{KERNEL_NAMES[kern]}.cu",
            "replaces": "dragonfly2_tpu/ops/flash.py:133",
            "launches": encoders[kern]["launches"],
            **{key: rows[kern][key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for kern in ("sm90", "tf32x3")
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"dragonfly2_torch/csrc/{KERNEL_NAMES[kern]}.cu",
            "replaces": "dragonfly2_tpu/ops/flash.py:185",
            "launches": grad_legs[leg]["launches_by"][kern],
            **{key: bwd_rows[row][key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        # flash_bwd_tf32x3[bfloat16 D=8] is the kernel's bf16 role, which no
        # path takes (the encoder's head dim is 64); flash_bwd is no route's
        # kernel since flash_bwd_tf32x3, timed in turns with the kernels that
        # replaced it: the path launches neither
        for name, kern, leg, row in (
            ("flash_bwd_sm90", "bwd_sm90", "bfloat16", "bwd_sm90"),
            ("flash_bwd_tf32x3[float32]", "bwd_tf32x3", "float32", "bwd_tf32x3"),
            ("flash_bwd_tf32x3[bfloat16 D=8]", "bwd_tf32x3", "bfloat16", "bwd_tf32x3_d8_bf16"),
            ("flash_bwd[float32]", "bwd", "float32", "bwd_float32"),
            ("flash_bwd[bfloat16]", "bwd", "bfloat16", "bwd_bfloat16"),
            ("flash_bwd[bfloat16 D=8]", "bwd", "bfloat16", "bwd_d8_bf16"),
        )
    ]
    head_dim = ENCODER["model_dim"] // ENCODER["num_heads"]
    on_path = {
        KERNEL_NAMES[route(dtype, head_dim)]
        for route in (flash.kernel_for, flash.bwd_kernel_for)
        for dtype in (torch.bfloat16, torch.float32)
    }
    for source in {f"dragonfly2_torch/csrc/{name}.cu" for name in on_path}:
        check(sum(k["launches"] for k in kernels if k["source"] == source) > 0,
              f"{source}: a kernel of the path was never launched")
    print(json.dumps({"kernels": kernels}))
    # again at the end: the card's line leads the output, which the
    # compilers' reports make long
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
