"""Service layer: broker, agents, registry, durable control store, wire format.

The networked counterpart of parallel.cluster.LocalCluster (reference
src/vizier/services/): query_broker (server.go:307 ExecuteScript), metadata
agent registry (agent.go:81-150), NATS/gRPC transports.  Control AND data ride
one framed-TCP transport here; the data plane payloads use a versioned binary
wire format (no pickle — untrusted bytes never reach an unpickler).

Copied from the reference package (pixie_tpu/services/): the wire frames,
the framed-TCP transport and its fault injector, the KV store, the agent
registry, health and leader election, the cron runner, and the broker,
agents and client, whose agents run their fragments on the CUDA card (or
the device the caller passes).  Not ported yet: replication, re-homing and
the chaos/rebalance harnesses (ROADMAP Queue 1 item 6d, part 2) and
tracepoints (item 6e).
"""
from pixie_tpu_torch.services.wire import (
    decode_frame,
    encode_host_batch,
    encode_json,
    encode_partial_agg,
)

__all__ = [
    "decode_frame",
    "encode_host_batch",
    "encode_json",
    "encode_partial_agg",
]
