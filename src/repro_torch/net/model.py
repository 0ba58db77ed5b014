"""NetModel — latency/bandwidth constants for the calibrated cost model.

Every transport backend derives its per-op and per-byte costs from these
constants (defaults ~ConnectX-4 100Gb/s, paper §7); benchmarks report the
derived ("sim") column next to measured wall time because this container's
single CPU core is not representative of RNIC/ICI-attached hosts.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NetModel:
    rdma_lat: float = 2e-6          # one-sided READ latency
    rdma_bw: float = 12.5e9         # 100 Gb/s
    rpc_lat: float = 8e-6           # two-sided RPC round trip
    rc_setup: float = 4e-3          # RC QP connect (paper: 4 ms)
    dct_setup: float = 1e-6         # DCT: piggybacked, <1 us
    dfs_lat: float = 100e-6         # distributed-FS request (CRIU-remote)
    disk_bw: float = 2e9            # checkpoint "disk" (tmpfs-ish)
    ici_lat: float = 1e-6           # TPU ICI hop (static mesh, no QP setup)
    ici_bw: float = 50e9            # TPU ICI per link (for TPU-mode derivations)
    node_links: int = 1             # wire transfers one node's NIC carries at
                                    # full bandwidth; every transfer occupies
                                    # one lane at EACH endpoint, so a K-way
                                    # fan-in queues on the parent link in
                                    # sim_time itself (<= 0 disables the link
                                    # clock: ledger-only legacy accounting)
    conn_cap: int = 0               # per-node connection-table slots (QP/DC
                                    # contexts a NIC holds); overflow evicts
                                    # LRU and the pair re-pays setup on next
                                    # use (<= 0 = unbounded, legacy behavior)
    op_timeout_s: float = 1e-3      # how long one op attempt holds its lane
                                    # before the initiator declares it lost
                                    # (injected fault / flapped peer NIC)
    retry_backoff_s: float = 5e-4   # linear backoff unit between attempts:
                                    # attempt k waits k * retry_backoff_s
