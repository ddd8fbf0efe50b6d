"""L4: cluster services — id generation, membership, ownership, RPC.

Rebuilds the capability of the reference's Akka-cluster control plane
(GlobalNodeIdService singleton, cluster sharding, distributed pub-sub) on a
pod-style multi-host model: consistent-hash entity ownership, host-to-host
RPC over TCP, a lease-based node-id singleton, and heartbeat membership
(SURVEY.md §5 "distributed communication backend", §7.1).
"""
