"""Cross-cluster federation: mirrored streams, cursors, DLX and Tx.

A *federation link* connects two independent clusters (each its own
membership, store and WAL) the way Pulsar's geo-replication connects
regions: the local cluster ships **sealed stream segments** to a named
remote, mirrors **named-cursor commits** so a consumer group can fail
over and resume contiguously from its committed offset, forwards
**dead-letter publishes** whose target exchange is owned by the remote,
and stages **Tx publishes** on the link boundary so a committed
transaction arrives at the far side as one all-or-nothing batch (riding
the same ``tx_batch`` WAL scope local commits use).

Transport is the length-prefixed binary framing: segment blobs,
Tx batches and DLX forwards ride the data-plane kinds (``KIND_DREQUEST``
/ ``KIND_DRESPONSE``) through a :class:`~..cluster.dataplane.DataStream`
whose ``inflight`` semaphore is the per-link in-flight window; control
traffic (handshake, resume, cursor mirror) uses the table-codec RPC
kinds on the same federation listener. Segment reads on the shipping
side go through ``store.select_stream_segment`` — the tiered-offload
path — so cold segments rehydrate transparently from the tier sidecar
(CRC-checked there) and are CRC32-checked again on the wire.

Resumability: the receiving side is the source of truth. ``fed.resume``
returns the mirror's ``next_offset`` per queue; the shipper ships only
from there, and any gap/duplicate race is settled by the receiver
(duplicates ack idempotently, gaps answer ``gap:<next>`` so the shipper
resyncs). A severed link therefore re-converges from whatever prefix
arrived, never double-applying and never skipping.

Observability follows the house pattern: ``federation_*`` counters in
the metrics registry, per-link ``chanamq_federation_link_lag`` gauges on
/metrics, ``federation.link.{up,down,resumed}`` and
``federation.cursor.mirrored`` events on the bus (plus a per-service
bounded transition log the soaks compare byte-for-byte), a
``federation-lag`` SLI feeding per-link SLO specs, and chaos seams
``fed.connect`` / ``fed.ship`` for deterministic fault injection.
"""

from __future__ import annotations

import json
from typing import Optional

from .link import FederationLink  # noqa: F401
from .service import FederationService  # noqa: F401


def links_from_json(raw: str) -> list[dict]:
    """Parse ``chana.mq.federation.links``: a JSON array of link specs
    (``name``, ``host``, ``port`` required; ``vhost`` defaults to "/",
    ``queues`` and ``exchanges`` to empty, ``window`` to the service
    default). Raises ValueError on garbage — a broken link spec should
    fail boot loudly, not ship nothing silently."""
    if not raw or not raw.strip():
        return []
    specs = json.loads(raw)
    if not isinstance(specs, list):
        raise ValueError("federation.links must be a JSON array")
    out = []
    for spec in specs:
        if not isinstance(spec, dict):
            raise ValueError(f"link spec must be an object: {spec!r}")
        for key in ("name", "host", "port"):
            if key not in spec:
                raise ValueError(f"link spec missing {key!r}: {spec!r}")
        out.append(spec)
    return out


async def enable_from_config(config, broker) -> Optional[FederationService]:
    """Boot-time wiring (``chana.mq.federation.enabled``): start the
    federation listener, build the configured links, hang the service off
    ``broker.federation``. Returns the started service (run_node stops it
    in the shutdown path)."""
    if not config.bool("chana.mq.federation.enabled"):
        return None
    raw_links = config.get("chana.mq.federation.links")
    if isinstance(raw_links, str):
        links = links_from_json(raw_links)  # env/JSON-file string form
    else:
        links = list(raw_links or [])       # already-parsed list form
    service = FederationService(
        broker,
        node_name=str(config.get("chana.mq.cluster.node-name") or ""),
        interface=config.str("chana.mq.federation.interface") or "127.0.0.1",
        port=config.int("chana.mq.federation.port") or 0,
        window=config.int("chana.mq.federation.window") or 4,
        retry_s=config.duration_s("chana.mq.federation.retry") or 0.5,
        idle_s=config.duration_s("chana.mq.federation.idle-tick") or 0.2,
        links=links,
        auth_token=config.str("chana.mq.federation.auth-token") or "",
    )
    await service.start()
    return service
