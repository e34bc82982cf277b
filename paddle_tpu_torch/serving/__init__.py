"""Serving (counterpart of ``paddle_tpu/serving/``): the paged greedy
``generation.SlotDecodeSession`` and its page pool, the batching
``server.BatchingServer`` over a ``Predictor``, graceful ``degradation``,
and the network plane: ``frontend.ServingFrontend`` (the socket
``predict`` / ``generate`` endpoints), ``client.ServingClient`` and the
``loadgen`` load generator. Decode snapshots, the router tier and beam
decode come with later slices (ROADMAP.md A8's second half, A7)."""

from paddle_tpu_torch.serving.server import (  # noqa: F401
    BatchingServer,
    DeadlineExceededError,
    QueueFullError,
    ServerClosedError,
    ServingError,
    ServingFuture,
    WaitTimeoutError,
)
