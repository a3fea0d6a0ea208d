"""Work split over processes.

Counterpart of event_flow_tpu/parallel/distributed.py's
``process_file_shard``: there the process index and count default to
JAX's; here the caller passes both (``loader.process_shard``, which
``eval_flow.py --shard I/N`` sets).
"""

__all__ = ["process_file_shard"]


def process_file_shard(files, process_id, process_count):
    """The disjoint round-robin share of ``files`` of process
    ``process_id`` of ``process_count``. Every process must pass the same
    (sorted) list."""
    if not 0 <= process_id < process_count:
        raise ValueError(f"process {process_id} of {process_count}")
    shard = files[process_id::process_count]
    if not shard:
        raise ValueError(f"process {process_id}/{process_count} got no "
                         f"files (have {len(files)})")
    return shard
