"""Concrete transport backends (§5.3 ablation axes + two new fabrics).

============  =========  ===========  ============================  ==========
name          one-sided  setup        read cost                     rpc cost
============  =========  ===========  ============================  ==========
``dct``       yes        dct_setup    rdma_lat + B/rdma_bw          rpc_lat
``rc``        yes        rc_setup     rdma_lat + B/rdma_bw          rpc_lat
``rpc``       no         —            rpc_lat  + B/rdma_bw          rpc_lat
``tpu_ici``   yes        —            ici_lat  + B/ici_bw           rpc_lat
``shared_fs`` no         —            dfs_lat  + B/disk_bw          dfs_lat
============  =========  ===========  ============================  ==========

``dct`` vs ``rc`` is the paper's DCT-vs-RC ablation: identical wire costs,
but RC pays a 4 ms QP connect per (src, dst) pair while DCT's setup is
piggybacked (<1 us).  ``rpc`` is the two-sided ablation path — the owner's
CPU serves every read.  ``tpu_ici`` models descriptor/page movement over a
TPU ICI link (static mesh: no connection setup, DMA-style one-sided).
``shared_fs`` is the CRIU-over-distributed-FS baseline: every read is a DFS
request plus checkpoint-disk bandwidth, two-sided and slow — the thing the
paper beats.
"""
from __future__ import annotations

from repro_torch.net.transport import Transport, register_transport


@register_transport
class DctTransport(Transport):
    """Connectionless RDMA (DC): one-sided reads, setup piggybacked."""

    name = "dct"
    one_sided = True
    connection_oriented = True
    conn_kind = "dc"               # one initiator/target context per node
    legacy_meter = "rdma"
    max_sge = 16                   # SGEs per doorbell-batched work request
    max_retries = 3                # DC re-posts are cheap: no QP to rebuild

    def setup_cost(self) -> float:
        return self.model.dct_setup

    def op_latency(self) -> float:
        return self.model.rdma_lat

    def bandwidth(self) -> float:
        return self.model.rdma_bw


@register_transport
class RcTransport(Transport):
    """Reliable-connected RDMA: one-sided reads behind a per-pair QP connect."""

    name = "rc"
    one_sided = True
    connection_oriented = True
    conn_kind = "peer"             # one QP per (src, dst), slots both ends
    legacy_meter = "rdma"
    max_sge = 16
    max_retries = 2                # each retry re-pays the 4 ms QP connect
                                   # (timeout moves the QP to error state)

    def setup_cost(self) -> float:
        return self.model.rc_setup

    def op_latency(self) -> float:
        return self.model.rdma_lat

    def bandwidth(self) -> float:
        return self.model.rdma_bw


@register_transport
class RpcTransport(Transport):
    """Two-sided ablation path: the owner's CPU serves every read.  Reads are
    still DC-key checked — the serving daemon refuses reclaimed VMAs — so
    revocation behaves identically to the one-sided backends."""

    name = "rpc"
    one_sided = False
    legacy_meter = "rpc"
    max_sge = 8                    # the daemon batches extents per request
    max_retries = 0                # the fallback path does not retry: a
                                   # timed-out daemon call fails over at
                                   # once (the caller picks another serve)

    def op_latency(self) -> float:
        return self.model.rpc_lat

    def bandwidth(self) -> float:
        return self.model.rdma_bw


@register_transport
class TpuIciTransport(Transport):
    """TPU ICI link: DMA-style one-sided movement over the static mesh —
    no connection setup, ici_bw per link."""

    name = "tpu_ici"
    one_sided = True
    legacy_meter = "ici"
    max_sge = 32                   # DMA descriptor ring, deep batching
    max_retries = 2

    def op_latency(self) -> float:
        return self.model.ici_lat

    def bandwidth(self) -> float:
        return self.model.ici_bw


@register_transport
class SharedFsTransport(Transport):
    """CRIU-over-distributed-FS baseline: reads and round trips both pay the
    DFS request latency and checkpoint-disk bandwidth."""

    name = "shared_fs"
    one_sided = False
    legacy_meter = "dfs"
    max_sge = 1                    # every extent is a separate DFS request
    max_retries = 1                # one slow re-read of the checkpoint file

    def op_latency(self) -> float:
        return self.model.dfs_lat

    def bandwidth(self) -> float:
        return self.model.disk_bw

    def rpc_latency(self) -> float:
        return self.model.dfs_lat
