"""PyTorch/CUDA port of the Dragonfly2 compute plane, for NVIDIA Hopper.

A package of its own beside ``dragonfly2_tpu`` (the JAX reference): its
modules mirror the reference's paths so each counterpart is easy to find,
and it imports neither JAX nor anything of the reference package. Entry
points take ``device=`` and default to ``"cuda"``; asking for CUDA on a
machine without a card raises instead of running on the CPU.

Ported so far: the scheduler's ``ml`` decision path — candidate filter
(``scheduler.scheduling``), wave evaluator (``scheduler.evaluator``),
batched scoring service (``scheduler.serving``) and model refresher over
the resource model, with the scoring plane under them (topology rtt
join, MLP ranked scoring, wave helpers); the trainer's fit path — the
Train stream (``trainer.service``) into per-host storage, the streamed
and batch MLP fits and the GraphSAGE fit (``trainer.training``,
``trainer.ingest``, ``trainer.train``) over the binary record format
(``schema.wire``), uploaded to the manager; and the piece-sequence
transformer encoder, whose attention runs on hand-written CUDA flash
kernels (``ops.flash``: ``csrc/flash_fwd_sm90.cu`` and
``csrc/flash_bwd_sm90.cu`` for bfloat16, ``csrc/flash_fwd_tf32x3.cu`` and
``csrc/flash_bwd_tf32x3.cu`` for float32) and trains through them, alone or under ring and Ulysses
sequence parallelism over ``torch.distributed`` (``ops.ring``,
``ops.ulysses``, ``parallel``); the GNN and GRU serving, seed
placement and the preheat plane; and the scheduler and trainer servers
(``scheduler.server``, ``trainer.server``, ``python -m
dragonfly2_torch.scheduler`` / ``python -m dragonfly2_torch.trainer``),
which daemons and the manager reach over gRPC on the reference's wire; and
the dfdaemon's download path (``client``: the daemon, seed peer or peer,
``python -m dragonfly2_torch.client.daemon``, with the ``dfget`` and
``dfcache`` CLIs).
"""

from dragonfly2_torch.device import compute_dtype, resolve_device

__all__ = ["compute_dtype", "resolve_device"]
