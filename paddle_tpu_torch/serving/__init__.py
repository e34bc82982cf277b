"""Serving (counterpart of ``paddle_tpu/serving/``): the paged
``generation.SlotDecodeSession`` (greedy, sampled, speculative and beam)
and its page pool, the batching ``server.BatchingServer`` over a
``Predictor``, graceful ``degradation``, decode snapshots
(``snapshot.DecodeSnapshotManager``: snapshot / restore of a live
session, bit-exact, in the JAX package's files) and the network plane:
``frontend.ServingFrontend`` (the socket ``predict`` / ``generate`` /
``snapshot`` / ``restore`` / ``attach`` endpoints),
``client.ServingClient`` and the ``loadgen`` load generator. The router
tier comes with a later slice (ROADMAP.md A item 5)."""

from paddle_tpu_torch.serving.server import (  # noqa: F401
    BatchingServer,
    DeadlineExceededError,
    QueueFullError,
    ServerClosedError,
    ServingError,
    ServingFuture,
    WaitTimeoutError,
)
from paddle_tpu_torch.serving.snapshot import (  # noqa: F401
    DecodeSnapshotManager,
    SnapshotMismatchError,
)
