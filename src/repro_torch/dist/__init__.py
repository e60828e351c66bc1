"""Distribution layer of the port: the key-routed shuffle and sharded
violation detection (DESIGN.md §8).

Modules:

    hints       ``Mesh`` (named axes over torch devices) and ``dp_axes``;
                a mesh spreading data over more than one device raises
    shuffle     ``shuffle_by_key``: hash-route rows so each key lives on
                exactly one shard; returns the inverse permutation
                (``src``) and an overflow flag for skewed keys
    detect      ``detect_dc_sharded`` / ``detect_fd_sharded``: violation
                detection over the routed layout, bit-identical to the
                dense scans of ``core/detect.py``; the DC scans of every
                shard run as one launch of the pair-scan kernel

The package re-exports the sharded-detection surface of the reference's
``repro.dist``, in particular ``ShardedDetectInfo``, the routing
observation (per-shard row counts, retry history) that the executor feeds
back into the cost model (DESIGN.md §10).  The reference's compressed
collectives, parameter sharding rules, pipeline parallelism and
activation hints serve training and the dry-run grid and are not ported.
"""

from repro_torch.dist.detect import (
    ShardedDetectInfo,
    detect_dc_sharded,
    detect_fd_sharded,
    pair_count_report,
)

__all__ = [
    "ShardedDetectInfo",
    "detect_dc_sharded",
    "detect_fd_sharded",
    "pair_count_report",
]
